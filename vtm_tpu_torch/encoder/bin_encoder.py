"""CABAC arithmetic encoder + fractional-bit estimator.

Behavioral mirror of EncoderLib/BinEncoder.cpp (BinEncoderBase +
TBinEncoder: encodeBin, encodeBinEP/BinsEP, encodeRemAbsEP, encodeBinTrm,
writeOut/finish) and the TBitEstimator twin (BinEncoder.h:226-271) whose
fractional-bit LUT (m_binFracBits) comes from the ROM.

Both update the shared ContextModels state exactly like the decoder's
engine, so encoder/decoder stay in sync bin-for-bin.
"""

from __future__ import annotations

import numpy as np

from vtm_tpu_torch.common import rom
from vtm_tpu_torch.decoder.cabac import MASK_0, MASK_1, ContextModels

_RENORM = rom.renorm_table().astype(np.int32)
_FRAC_BITS = rom.bin_frac_bits().astype(np.int64)  # (256, 2)


class BinEncoder:
    """Arithmetic encoder writing into a BitWriter."""

    def __init__(self, bit_writer, ctx: ContextModels):
        self.bw = bit_writer
        self.ctx = ctx
        self.low = 0
        self.range = 510
        self.buffered_byte = 0xFF
        self.num_buffered = 0
        self.bits_left = 23

    def start(self):
        self.low = 0
        self.range = 510
        self.buffered_byte = 0xFF
        self.num_buffered = 0
        self.bits_left = 23

    def _write_out(self):
        lead = self.low >> (24 - self.bits_left)
        self.bits_left += 8
        self.low &= 0xFFFFFFFF >> self.bits_left
        if lead == 0xFF:
            self.num_buffered += 1
        else:
            if self.num_buffered > 0:
                carry = lead >> 8
                byte = self.buffered_byte + carry
                self.buffered_byte = lead & 0xFF
                self.bw.u(byte & 0xFF, 8)
                byte = (0xFF + carry) & 0xFF
                while self.num_buffered > 1:
                    self.bw.u(byte, 8)
                    self.num_buffered -= 1
            else:
                self.num_buffered = 1
                self.buffered_byte = lead

    def encode_bin(self, bin_val: int, ctx_id: int):
        c = self.ctx
        s0 = int(c.state0[ctx_id])
        s1 = int(c.state1[ctx_id])
        q = (s0 + s1) >> 8
        mps = q >> 7
        qq = q ^ 0xFF if (q & 0x80) else q
        lps = ((qq >> 2) * (self.range >> 5) >> 1) + 4
        self.range -= lps
        if bin_val != mps:
            nb = int(_RENORM[lps >> 3])
            self.bits_left -= nb
            self.low = (self.low + self.range) << nb
            self.range = lps << nb
            if self.bits_left < 12:
                self._write_out()
        else:
            if self.range < 256:
                self.low <<= 1
                self.range <<= 1
                self.bits_left -= 1
                if self.bits_left < 12:
                    self._write_out()
        r0 = int(c.rate0[ctx_id])
        r1 = int(c.rate1[ctx_id])
        s0 -= (s0 >> r0) & MASK_0
        s1 -= (s1 >> r1) & MASK_1
        if bin_val:
            s0 += (0x7FFF >> r0) & MASK_0
            s1 += (0x7FFF >> r1) & MASK_1
        c.state0[ctx_id] = s0
        c.state1[ctx_id] = s1

    def encode_bin_ep(self, bin_val: int):
        self.low <<= 1
        if bin_val:
            self.low += self.range
        self.bits_left -= 1
        if self.bits_left < 12:
            self._write_out()

    def encode_bins_ep(self, bins: int, num_bins: int):
        if num_bins == 0:
            return
        if self.range == 256:
            self._encode_aligned_bins_ep(bins, num_bins)
            return
        while num_bins > 8:
            num_bins -= 8
            pattern = bins >> num_bins
            self.low = (self.low << 8) + self.range * pattern
            bins -= pattern << num_bins
            self.bits_left -= 8
            if self.bits_left < 12:
                self._write_out()
        self.low = (self.low << num_bins) + self.range * bins
        self.bits_left -= num_bins
        if self.bits_left < 12:
            self._write_out()

    def _encode_aligned_bins_ep(self, bins: int, num_bins: int):
        rem = num_bins
        while rem > 0:
            n = min(rem, 8)
            mask = (1 << n) - 1
            new_bins = (bins >> (rem - n)) & mask
            self.low = (self.low << n) + (new_bins << 8)
            rem -= n
            self.bits_left -= n
            if self.bits_left < 12:
                self._write_out()

    def encode_rem_abs_ep(self, bins: int, go_rice: int, cutoff: int, max_log2_tr_dr: int):
        threshold = cutoff << go_rice
        if bins < threshold:
            mask = (1 << go_rice) - 1
            length = (bins >> go_rice) + 1
            self.encode_bins_ep((1 << length) - 2, length)
            self.encode_bins_ep(bins & mask, go_rice)
        else:
            max_prefix_len = 32 - cutoff - max_log2_tr_dr
            prefix_len = 0
            code_value = (bins >> go_rice) - cutoff
            if code_value >= (1 << max_prefix_len) - 1:
                prefix_len = max_prefix_len
                suffix_len = max_log2_tr_dr
            else:
                while code_value > (2 << prefix_len) - 2:
                    prefix_len += 1
                suffix_len = prefix_len + go_rice + 1
            total_prefix_len = prefix_len + cutoff
            mask = (1 << go_rice) - 1
            prefix = (1 << total_prefix_len) - 1
            suffix = ((code_value - ((1 << prefix_len) - 1)) << go_rice) | (bins & mask)
            self.encode_bins_ep(prefix, total_prefix_len)
            self.encode_bins_ep(suffix, suffix_len)

    def encode_bin_trm(self, bin_val: int):
        self.range -= 2
        if bin_val:
            self.low += self.range
            self.low <<= 7
            self.range = 2 << 7
            self.bits_left -= 7
        elif self.range >= 256:
            return
        else:
            self.low <<= 1
            self.range <<= 1
            self.bits_left -= 1
        if self.bits_left < 12:
            self._write_out()

    def finish(self):
        if self.low >> (32 - self.bits_left):
            self.bw.u(self.buffered_byte + 1, 8)
            while self.num_buffered > 1:
                self.bw.u(0x00, 8)
                self.num_buffered -= 1
            self.low -= 1 << (32 - self.bits_left)
        else:
            if self.num_buffered > 0:
                self.bw.u(self.buffered_byte, 8)
            while self.num_buffered > 1:
                self.bw.u(0xFF, 8)
                self.num_buffered -= 1
        self.bw.u(self.low >> 8, 24 - self.bits_left)


import itertools

_LINEAGE = itertools.count()


class BitEstimator:
    """TBitEstimator: accumulates fractional bits (1/32768) and updates
    contexts; API-compatible with BinEncoder for RD trials.

    `lineage` identifies the root estimator a copy descends from (fresh
    per slice); consumers that cache derived data across RD branches
    (dq_ctx rate tables) key on (lineage, frac_bits epoch) so copies
    share the cache instead of thrashing on object identity."""

    def __init__(self, ctx: ContextModels):
        self.ctx = ctx
        self.frac_bits = 0
        self.lineage = next(_LINEAGE)

    def copy(self) -> "BitEstimator":
        e = BitEstimator(self.ctx.copy())
        e.frac_bits = self.frac_bits
        e.lineage = self.lineage
        return e

    def encode_bin(self, bin_val: int, ctx_id: int):
        c = self.ctx
        s0 = int(c.state0[ctx_id])
        s1 = int(c.state1[ctx_id])
        state = (s0 + s1) >> 8
        self.frac_bits += int(_FRAC_BITS[state][bin_val])
        r0 = int(c.rate0[ctx_id])
        r1 = int(c.rate1[ctx_id])
        s0 -= (s0 >> r0) & MASK_0
        s1 -= (s1 >> r1) & MASK_1
        if bin_val:
            s0 += (0x7FFF >> r0) & MASK_0
            s1 += (0x7FFF >> r1) & MASK_1
        c.state0[ctx_id] = s0
        c.state1[ctx_id] = s1

    def encode_bin_ep(self, bin_val: int):
        self.frac_bits += 1 << 15

    def encode_bins_ep(self, bins: int, num_bins: int):
        self.frac_bits += num_bins << 15

    def encode_rem_abs_ep(self, bins: int, go_rice: int, cutoff: int, max_log2_tr_dr: int):
        # count the EP bins the real encoder would produce
        threshold = cutoff << go_rice
        if bins < threshold:
            length = (bins >> go_rice) + 1 + go_rice
        else:
            max_prefix_len = 32 - cutoff - max_log2_tr_dr
            prefix_len = 0
            code_value = (bins >> go_rice) - cutoff
            if code_value >= (1 << max_prefix_len) - 1:
                prefix_len = max_prefix_len
                suffix_len = max_log2_tr_dr
            else:
                while code_value > (2 << prefix_len) - 2:
                    prefix_len += 1
                suffix_len = prefix_len + go_rice + 1
            length = prefix_len + cutoff + suffix_len
        self.frac_bits += length << 15

    def encode_bin_trm(self, bin_val: int):
        self.frac_bits += 0x3BFBB if bin_val else 0x0010C

    @property
    def bits(self) -> float:
        return self.frac_bits / 32768.0
