"""Bit-level writers: RBSP construction, EBSP emulation, Annex-B output.

Behavioral mirror of CommonLib/BitStream.cpp (OutputBitstream) and
EncoderLib/NALwrite.cpp + AnnexBwrite.h.
"""

from __future__ import annotations


class BitWriter:
    """MSB-first bit writer producing an RBSP."""

    def __init__(self):
        self.bytes = bytearray()
        self.held = 0
        self.held_bits = 0

    def u(self, value: int, n: int) -> None:
        assert n <= 32 and value >= 0 and value < (1 << n), (value, n)
        while n > 0:
            take = min(8 - self.held_bits, n)
            self.held = (self.held << take) | ((value >> (n - take)) & ((1 << take) - 1))
            self.held_bits += take
            n -= take
            if self.held_bits == 8:
                self.bytes.append(self.held)
                self.held = 0
                self.held_bits = 0

    def flag(self, v) -> None:
        self.u(1 if v else 0, 1)

    def ue(self, value: int) -> None:
        assert value >= 0
        code = value + 1
        length = code.bit_length()
        self.u(0, length - 1)
        self.u(code, length)

    def se(self, value: int) -> None:
        self.ue(2 * value - 1 if value > 0 else -2 * value)

    @property
    def bit_pos(self) -> int:
        return len(self.bytes) * 8 + self.held_bits

    def byte_aligned(self) -> bool:
        return self.held_bits == 0

    def write_rbsp_trailing(self) -> None:
        self.u(1, 1)
        while self.held_bits:
            self.u(0, 1)

    def write_byte_alignment(self) -> None:
        """slice-data byte alignment: one 1 bit + zero pad."""
        self.u(1, 1)
        while self.held_bits:
            self.u(0, 1)

    def data(self) -> bytes:
        assert self.held_bits == 0, "unaligned rbsp"
        return bytes(self.bytes)


def rbsp_to_ebsp(rbsp: bytes) -> bytes:
    """Insert emulation-prevention bytes."""
    out = bytearray()
    zeros = 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


def make_nal(nal_unit_type: int, rbsp: bytes, temporal_id: int = 0,
             layer_id: int = 0, long_start_code: bool = True) -> bytes:
    header = bytes([layer_id & 0x3F, (nal_unit_type << 3) | (temporal_id + 1)])
    start = b"\x00\x00\x00\x01" if long_start_code else b"\x00\x00\x01"
    return start + rbsp_to_ebsp(header + rbsp)
