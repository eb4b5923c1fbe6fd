"""Numpy-seeded inputs for the in-loop filter kernels.

Shared by the kernel tests (the jax reference against the plain torch
versions) and chip_smoke.py (the CUDA kernels against the plain versions).
Everything is numpy, so the same arrays feed both packages.

Planes are blocky (8x8 steps plus small noise), so the deblocking
decisions, SAO edge classes and ALF classes all take several values.
Active deblocking edges are 16 samples apart (8 in subsampled chroma), as
the max-filter-length rules keep real edges: no sample is written by two
edges.
"""

from __future__ import annotations

import numpy as np

from vtm_tpu_torch.ops import alf_kernel as AK

# (sx, sy) of each chroma format
FORMATS = {"420": (1, 1), "422": (1, 0), "444": (0, 0)}


def plane(rng, h: int, w: int, bit_depth: int) -> np.ndarray:
    maxv = (1 << bit_depth) - 1
    amp = 1 << (bit_depth - 5)
    blocks = rng.integers(-amp, amp + 1, size=((h + 7) // 8, (w + 7) // 8))
    p = (maxv + 1) // 2 + np.kron(blocks, np.ones((8, 8), dtype=np.int64))[:h, :w]
    p = p + rng.integers(-(1 << (bit_depth - 8)), (1 << (bit_depth - 8)) + 1, size=(h, w))
    p = p + (np.arange(w)[None, :] * amp) // max(w, 1)
    # a few samples at the ends of the range exercise every clip
    n = max(1, h * w // 200)
    p[rng.integers(0, h, n), rng.integers(0, w, n)] = rng.choice([0, maxv], n)
    return np.clip(p, 0, maxv).astype(np.int32)


def planes(rng, h: int, w: int, fmt: str, bit_depth: int):
    sx, sy = FORMATS[fmt]
    return (plane(rng, h, w, bit_depth), plane(rng, h >> sy, w >> sx, bit_depth),
            plane(rng, h >> sy, w >> sx, bit_depth))


def deblock_maps(rng, h: int, w: int, bit_depth: int, hor: bool) -> tuple:
    """The 17 deblock_dir maps ([h/4, w/4], picture orientation) of one
    direction, in vtm_tpu_torch.ops.filter_chain.DMAP_FIELDS order."""
    h4, w4 = h // 4, w // 4
    r, c = np.mgrid[0:h4, 0:w4]
    on_grid = (r % 4 == 0) if hor else (c % 4 == 0)
    scale = 1 << (bit_depth - 8)

    def flag(p):
        return rng.random((h4, w4)) < p

    def ints(lo, hi):
        return rng.integers(lo, hi + 1, size=(h4, w4)).astype(np.int32)

    maxlen = np.array([1, 2, 3, 5, 7], dtype=np.int32)
    luma = (flag(0.85) & on_grid, ints(0, 25 * scale), ints(0, 88 * scale),
            rng.choice(maxlen, (h4, w4)), rng.choice(maxlen, (h4, w4)),
            flag(0.1), flag(0.1))
    chroma = []
    for _ in range(2):
        chroma += [flag(0.85) & on_grid, ints(0, 25 * scale), ints(0, 88 * scale)]
    shared = (flag(0.7), flag(0.1), flag(0.1), flag(0.3))
    return luma + tuple(chroma) + shared


def sao_maps(rng, h: int, w: int, n_ctu: int, bit_depth: int) -> tuple:
    """(type_map, ctu_map, offsets, valid) of one plane."""
    hb, wb = (h + 7) // 8, (w + 7) // 8

    def blocks(a):
        return np.kron(a, np.ones((8, 8), dtype=a.dtype))[:h, :w]

    type_map = blocks(rng.integers(0, 5, size=(hb, wb))).astype(np.int32)
    ctu_map = blocks(rng.integers(0, n_ctu, size=(hb, wb))).astype(np.int32)
    lim = 7 << max(0, bit_depth - 8)
    offsets = rng.integers(-lim, lim + 1, size=(n_ctu, 32)).astype(np.int32)
    valid = rng.random((h, w)) < 0.9
    return type_map, ctu_map, offsets, valid


def alf_tables(rng, h: int, w: int, fmt: str, bit_depth: int, ctu: int):
    """The 22 alf_all tables of a picture with CTUs of `ctu` samples (so
    virtual-boundary rows fall inside it), random coefficients and clips,
    and CTU 0 with every filter off (zero coefficients: identity)."""
    sx, sy = FORMATS[fmt]
    maxv = (1 << bit_depth) - 1
    w_ctu, h_ctu = -(-w // ctu), -(-h // ctu)
    n_ctu = w_ctu * h_ctu
    cperm = rng.integers(-64, 65, size=(n_ctu, 25, 4, 12)).astype(np.int32)
    lperm = rng.integers(0, maxv + 1, size=(n_ctu, 25, 4, 12)).astype(np.int32)
    cperm[0] = 0
    by, bx = np.mgrid[0:h // 4, 0:w // 4]
    ctu_of = ((by * 4 // ctu) * w_ctu + (bx * 4 // ctu)).astype(np.int32)
    vb = ctu - 4
    l_orows, l_near = AK.vb_row_offsets(h, ctu, vb, True)
    rows = AK.classify_row_indices(h, ctu, vb)
    blocks = AK.classify_block_rows(h, ctu, vb)
    hc, wc = h >> sy, w >> sx
    cby, cbx = np.mgrid[0:hc // 4, 0:wc // 4]
    ctu_of_c = ((cby * 4) << sy) // ctu * w_ctu + ((cbx * 4) << sx) // ctu
    off_c = (ctu_of_c == 0)[:, :, None]

    def cmap(n, lo, hi):
        m = rng.integers(lo, hi + 1, size=(hc // 4, wc // 4, n)).astype(np.int32)
        return np.where(off_c, 0, m).astype(np.int32)

    c_orows, c_near = AK.vb_row_offsets(hc, ctu >> sy, (ctu >> sy) - 2, False)
    cc_orows, cc_skip = AK.ccalf_row_offsets(hc, sy, ctu, vb)
    args = (cperm, lperm, ctu_of, l_orows, l_near, *rows, *blocks,
            cmap(6, -64, 64), cmap(6, 0, maxv), cmap(6, -64, 64),
            cmap(6, 0, maxv), c_orows, c_near, cmap(7, -32, 32),
            cmap(7, -32, 32), cc_orows, cc_skip)
    return args
