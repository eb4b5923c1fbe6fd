"""Normative constant tables (ROM).

The arrays in `rom_tables.npz` are VVC-spec constants (transform cores, CABAC
initialization values, scan orders, MIP/LFNST weights, interpolation filter
taps, quant scales) extracted bit-identically from the reference build by
`tools/dump_rom.cpp` + `tools/make_rom.sh`.  Any conforming implementation
must contain these exact values; none of the reference's *logic* is reused.

Reference provenance: RomTr.cpp, RomLFNST.cpp, MipData.h, Contexts.cpp,
Rom.cpp (initROM scan tables), InterpolationFilter.cpp:57-312, Quant.cpp.
"""

from __future__ import annotations

import functools
import os

import numpy as np

_NPZ = os.path.join(os.path.dirname(os.path.abspath(__file__)), "rom_tables.npz")


@functools.cache
def _tables() -> dict[str, np.ndarray]:
    with np.load(_NPZ) as z:
        return {k: z[k] for k in z.files}


def get(name: str) -> np.ndarray:
    return _tables()[name]


# ---------------------------------------------------------------------------
# Transform cores.  Index [0] = forward (6-bit in this build config),
# [1] = inverse (6-bit).  Rows are basis functions.
# ---------------------------------------------------------------------------

@functools.cache
def tr_matrix(kind: str, size: int, forward: bool) -> np.ndarray:
    """kind in {DCT2, DCT8, DST7}; returns (size, size) int32 basis matrix."""
    return get(f"tr{kind}P{size}")[0 if forward else 1]


@functools.cache
def lfnst_matrix(mode_group: int, idx: int, size: int) -> np.ndarray:
    """LFNST kernel: size 4 → (16,16), size 8 → (16,48)."""
    key = "lfnst4x4" if size == 4 else "lfnst8x8"
    return get(key)[mode_group][idx]


def lfnst_lut() -> np.ndarray:
    return get("lfnstLut")


# ---------------------------------------------------------------------------
# Quantization scales: g_quantScales[is2xBlock][qp%6], inv likewise.
# ---------------------------------------------------------------------------

def quant_scale(rem: int, needs_sqrt2: bool) -> int:
    return int(get("quantScales")[1 if needs_sqrt2 else 0][rem])


def inv_quant_scale(rem: int, needs_sqrt2: bool) -> int:
    return int(get("invQuantScales")[1 if needs_sqrt2 else 0][rem])


# ---------------------------------------------------------------------------
# Coefficient scan orders.  scan(group, w, h) → (N,3) array of (rasterIdx,x,y)
# in scan order; group 1 = grouped 4x4 (used by residual coding).
# ---------------------------------------------------------------------------

@functools.cache
def scan(group: int, w: int, h: int) -> np.ndarray:
    return get(f"scan_g{group}_{w}x{h}")


@functools.cache
def log2_sbb_size(log2w: int, log2h: int) -> tuple[int, int]:
    t = get("log2SbbSize")
    return int(t[log2w][log2h][0]), int(t[log2w][log2h][1])


def group_idx() -> np.ndarray:
    return get("groupIdx")


def min_in_group() -> np.ndarray:
    return get("minInGroup")


def go_rice_pars_coeff() -> np.ndarray:
    return get("goRiceParsCoeff")


# ---------------------------------------------------------------------------
# CABAC context model init.
# ---------------------------------------------------------------------------

@functools.cache
def ctx_init_table(init_id: int) -> np.ndarray:
    """init_id 0/1/2 = slice-type B/P/I value tables, 3 = window sizes."""
    return get(f"ctxInit{init_id}")


@functools.cache
def ctx_offsets() -> dict[str, tuple[int, int]]:
    """Named context set → (offset, size) into the flat context array."""
    out = {}
    for k, v in _tables().items():
        if k.startswith("ctxoff_"):
            out[k[len("ctxoff_"):]] = (int(v[0]), int(v[1]))
    return out


def num_contexts() -> int:
    return int(get("numContexts")[0])


def renorm_table() -> np.ndarray:
    return get("renormTable32")


def bin_frac_bits() -> np.ndarray:
    return get("binFracBits")


# ---------------------------------------------------------------------------
# Interpolation filters / MIP / misc.
# ---------------------------------------------------------------------------

def luma_filter() -> np.ndarray:
    return get("lumaFilter")  # (16, 8)


def chroma_filter() -> np.ndarray:
    return get("chromaFilter")  # (32, 4)


def mip_matrix(size_id: int) -> np.ndarray:
    return get(["mipMatrix4x4", "mipMatrix8x8", "mipMatrix16x16"][size_id])


def chroma422_angle_mapping() -> np.ndarray:
    return get("chroma422IntraAngleMapping")
