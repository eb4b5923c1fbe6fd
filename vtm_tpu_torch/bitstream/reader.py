"""Bit-level readers over RBSP payloads.

Behavioral equivalent of the reference's `source/Lib/CommonLib/BitStream.cpp`
(InputBitstream) + `source/Lib/DecoderLib/AnnexBread.cpp` (start-code
scanning) + `NALread.cpp` (EBSP→RBSP, NAL header): byte-oriented MSB-first
bit reading with ue(v)/se(v) exp-Golomb, emulation-prevention removal, and
Annex-B access-unit splitting.
"""

from __future__ import annotations

from dataclasses import dataclass


def split_annexb(data: bytes) -> list[bytes]:
    """Split an Annex-B byte stream into EBSP NAL payloads (no start codes).

    Mirrors byteStreamNALUnit (AnnexBread.cpp): NALs are delimited by
    0x000001 / 0x00000001 start codes; trailing zero bytes are dropped.
    """
    nals = []
    i = 0
    n = len(data)
    # find first start code
    while i + 3 <= n and data[i : i + 3] != b"\x00\x00\x01":
        i += 1
    i += 3
    start = i
    while i + 3 <= n:
        if data[i : i + 3] == b"\x00\x00\x01":
            end = i
            # strip trailing zeros that belong to the next start code prefix
            while end > start and data[end - 1] == 0:
                end -= 1
            nals.append(data[start:end])
            i += 3
            start = i
        else:
            i += 1
    if start < n:
        end = n
        while end > start and data[end - 1] == 0:
            end -= 1
        nals.append(data[start:end])
    return nals


def ebsp_to_rbsp(ebsp: bytes) -> bytes:
    """Remove emulation-prevention bytes (00 00 03 xx → 00 00 xx)."""
    if b"\x00\x00\x03" not in ebsp:
        return ebsp
    out = bytearray()
    zeros = 0
    i = 0
    n = len(ebsp)
    while i < n:
        b = ebsp[i]
        if zeros >= 2 and b == 3 and i + 1 < n and ebsp[i + 1] <= 3:
            zeros = 0
            i += 1
            continue
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
        i += 1
    return bytes(out)


@dataclass
class NalUnit:
    """Parsed VVC NAL unit header (NALread.cpp readNalUnitHeader) + RBSP."""

    nal_unit_type: int
    temporal_id: int
    layer_id: int
    rbsp: bytes


# VVC nal_unit_type values (ref: CommonDef.h NalUnitType / spec Table 5)
NAL_TRAIL = 0
NAL_STSA = 1
NAL_RADL = 2
NAL_RASL = 3
NAL_IDR_W_RADL = 7
NAL_IDR_N_LP = 8
NAL_CRA = 9
NAL_GDR = 10
NAL_OPI = 12
NAL_DCI = 13
NAL_VPS = 14
NAL_SPS = 15
NAL_PPS = 16
NAL_PREFIX_APS = 17
NAL_SUFFIX_APS = 18
NAL_PH = 19
NAL_AUD = 20
NAL_EOS = 21
NAL_EOB = 22
NAL_PREFIX_SEI = 23
NAL_SUFFIX_SEI = 24

SLICE_NAL_TYPES = frozenset(
    [NAL_TRAIL, NAL_STSA, NAL_RADL, NAL_RASL, NAL_IDR_W_RADL, NAL_IDR_N_LP,
     NAL_CRA, NAL_GDR]
)
IRAP_NAL_TYPES = frozenset([NAL_IDR_W_RADL, NAL_IDR_N_LP, NAL_CRA])


def parse_nal(ebsp: bytes) -> NalUnit:
    """Parse the 2-byte VVC NAL header and de-emulate the payload."""
    b0, b1 = ebsp[0], ebsp[1]
    assert (b0 >> 7) == 0, "forbidden_zero_bit"
    layer_id = b0 & 0x3F
    nal_type = b1 >> 3
    tid = (b1 & 0x7) - 1
    return NalUnit(nal_type, tid, layer_id, ebsp_to_rbsp(ebsp[2:]))


class BitReader:
    """MSB-first bit reader over an RBSP (InputBitstream equivalent)."""

    __slots__ = ("data", "pos", "n_bits")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0  # bit position
        self.n_bits = 8 * len(data)

    def u(self, n: int) -> int:
        """Read n bits unsigned (f(n)/u(n))."""
        if n == 0:
            return 0
        pos = self.pos
        end = pos + n
        if end > self.n_bits:
            raise EOFError("bitstream exhausted")
        byte0 = pos >> 3
        byte1 = (end + 7) >> 3
        acc = int.from_bytes(self.data[byte0:byte1], "big")
        acc >>= (byte1 << 3) - end
        self.pos = end
        return acc & ((1 << n) - 1)

    def flag(self) -> int:
        return self.u(1)

    def ue(self) -> int:
        """Exp-Golomb unsigned."""
        zeros = 0
        while self.u(1) == 0:
            zeros += 1
            if zeros > 32:
                raise ValueError("invalid exp-Golomb code")
        if zeros == 0:
            return 0
        return (1 << zeros) - 1 + self.u(zeros)

    def se(self) -> int:
        """Exp-Golomb signed."""
        k = self.ue()
        return (k + 1) >> 1 if (k & 1) else -(k >> 1)

    def byte_aligned(self) -> bool:
        return (self.pos & 7) == 0

    def align(self) -> None:
        self.pos = (self.pos + 7) & ~7

    def bits_left(self) -> int:
        return self.n_bits - self.pos

    def more_rbsp_data(self) -> bool:
        """True if there is RBSP data before rbsp_stop_one_bit."""
        if self.pos >= self.n_bits:
            return False
        # find last byte with any set bit (the rbsp trailing byte)
        i = len(self.data) - 1
        while i >= 0 and self.data[i] == 0:
            i -= 1
        if i < 0:
            return False
        last = self.data[i]
        # position of the stop bit = lowest set bit of last byte
        stop_bit_pos = (i << 3) + 7 - ((last & -last).bit_length() - 1)
        return self.pos < stop_bit_pos
