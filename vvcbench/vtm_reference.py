"""The plain reference of the decode cells: VTM 9.3 DecoderApp's output,
recorded as the MD5 of every plane of every picture it decoded
(`streams/<stream>.dec.log`, as DecoderApp printed it), and the same
digest taken here with hashlib over the program's planes.

The MD5 is the one of the decoded picture hash SEI: the samples row by
row, one byte each at 8 bits and two, little-endian, above.  Nothing here
reads the program's own hash checks.
"""

from __future__ import annotations

import hashlib
import re

import numpy as np

LINE_RE = re.compile(r"^POC\s+(\d+)\b.*\[MD5:([0-9a-f]{32}),([0-9a-f]{32}),([0-9a-f]{32})")


def read_log(path: str) -> dict[int, tuple[str, str, str]]:
    """POC -> the (Y, Cb, Cr) MD5s of a DecoderApp log."""
    out = {}
    with open(path) as f:
        for line in f:
            m = LINE_RE.match(line)
            if m:
                out[int(m.group(1))] = m.group(2, 3, 4)
    if not out:
        raise ValueError(f"{path}: no picture lines")
    return out


def plane_md5(plane, bit_depth: int) -> str | None:
    """The plane's MD5, or None where a sample lies outside the bit depth."""
    a = np.asarray(plane)
    if a.size and (a.min() < 0 or a.max() >= 1 << bit_depth):
        return None
    return hashlib.md5(a.astype(np.uint8 if bit_depth <= 8 else "<u2").tobytes()).hexdigest()


def wrong_pictures(expected: dict, got: list, bit_depth: int) -> int:
    """Pictures of one stream that are missing, extra, repeated, or differ
    from the reference in any plane.  `got` is [(poc, planes)]."""
    seen, wrong = set(), 0
    for poc, planes in got:
        want = expected.get(poc)
        if want is None or poc in seen or len(planes) != len(want):
            wrong += 1
        elif any(plane_md5(p, bit_depth) != w for p, w in zip(planes, want)):
            wrong += 1
        seen.add(poc)
    return wrong + len(set(expected) - seen)
