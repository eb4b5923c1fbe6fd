"""The plain reference of the encode cells: for each frame, the stream that
vtm_tpu (the jax package) wrote for it with the configuration's settings
(`streams/*.bit`), and the MD5 of each plane of its reconstruction
(`streams/*.rec.log`, one `POC 0 ... [MD5:y,cb,cr]` line).  Made off the
card, on the CPU, and committed as data; nothing here imports the program
or the jax package.

A picture is wrong where its stream differs from the reference's in any
byte, or a plane of its reconstruction from the reference's MD5 (taken
here with hashlib, vtm_reference.plane_md5).
"""

from __future__ import annotations

from vvcbench import vtm_reference


def wrong_picture(want_bits: bytes, want_md5: tuple, got_bits: bytes, recon,
                  bit_depth: int) -> bool:
    """Whether one encoded picture differs from the reference: its stream
    in any byte, or a reconstructed plane in its MD5."""
    if got_bits != want_bits or recon is None or len(recon) != len(want_md5):
        return True
    return any(vtm_reference.plane_md5(p, bit_depth) != w for p, w in zip(recon, want_md5))
