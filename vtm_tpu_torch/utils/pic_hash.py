"""Decoded-picture hashes (MD5 / CRC / checksum).

Behavioral equivalent of the reference's `source/Lib/CommonLib/PicYuvMD5.cpp`
(calcMD5:188, compCRC:93, compChecksum:143): per-plane digests over
reconstruction samples, little-endian, 1 byte/sample for bit depth <= 8 else
2 bytes.  This is the primary conformance oracle — our decode must reproduce
the hash carried in the decoded_picture_hash SEI (payload type 132).
"""

from __future__ import annotations

import hashlib

import numpy as np


def _plane_bytes(plane: np.ndarray, bit_depth: int) -> bytes:
    if bit_depth <= 8:
        return plane.astype(np.uint8).tobytes()
    return plane.astype("<u2").tobytes()


def pic_md5(planes: list[np.ndarray], bit_depths: list[int]) -> bytes:
    """Concatenated per-plane MD5 digests (16 bytes per plane)."""
    out = b""
    for plane, bd in zip(planes, bit_depths):
        out += hashlib.md5(_plane_bytes(plane, bd)).digest()
    return out


def _crc16_plane(plane: np.ndarray, bit_depth: int) -> int:
    """CRC-16/CCITT over sample bits, matching compCRC bit order."""
    crc = 0xFFFF
    data = plane.astype(np.int64).ravel()
    # bytewise CRC over LSB (then next byte if >8 bit), MSB-first per byte
    for v in data:
        for byte in ((v & 0xFF),) + (((v >> 8) & 0xFF,) if bit_depth > 8 else ()):
            for bit_idx in range(8):
                msb = (crc >> 15) & 1
                bit = (byte >> (7 - bit_idx)) & 1
                crc = (((crc << 1) + bit) & 0xFFFF) ^ (msb * 0x1021)
    for _ in range(16):
        msb = (crc >> 15) & 1
        crc = ((crc << 1) & 0xFFFF) ^ (msb * 0x1021)
    return crc


def pic_crc(planes: list[np.ndarray], bit_depths: list[int]) -> bytes:
    out = b""
    for plane, bd in zip(planes, bit_depths):
        crc = _crc16_plane(plane, bd)
        out += bytes([(crc >> 8) & 0xFF, crc & 0xFF])
    return out


def pic_checksum(planes: list[np.ndarray], bit_depths: list[int]) -> bytes:
    out = b""
    for plane, bd in zip(planes, bit_depths):
        h, w = plane.shape
        x = np.arange(w, dtype=np.uint32)[None, :]
        y = np.arange(h, dtype=np.uint32)[:, None]
        xor_mask = ((x & 0xFF) ^ (y & 0xFF) ^ (x >> 8) ^ (y >> 8)).astype(np.uint32)
        p = plane.astype(np.uint32)
        s = np.uint32(np.sum((p & 0xFF) ^ xor_mask, dtype=np.uint64) & 0xFFFFFFFF)
        if bd > 8:
            s = np.uint32(
                (int(s) + int(np.sum((p >> 8) ^ xor_mask, dtype=np.uint64)))
                & 0xFFFFFFFF
            )
        v = int(s)
        out += bytes([(v >> 24) & 0xFF, (v >> 16) & 0xFF, (v >> 8) & 0xFF, v & 0xFF])
    return out


HASH_FUNCS = {0: pic_md5, 1: pic_crc, 2: pic_checksum}  # SEI hash_type values


def hash_to_string(digest: bytes, bytes_per_plane: int) -> str:
    """Format like the reference log: hex, comma between planes."""
    s = digest.hex()
    n = bytes_per_plane * 2
    return ",".join(s[i : i + n] for i in range(0, len(s), n))
