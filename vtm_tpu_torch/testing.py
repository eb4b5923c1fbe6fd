"""Numpy-seeded inputs for the port's kernels.

Shared by the kernel tests (the jax reference against the plain torch
versions) and chip_smoke.py (the CUDA kernels against the plain versions).
Everything is numpy, so the same arrays feed both packages.

Planes are blocky (8x8 steps plus small noise), so the deblocking
decisions, SAO edge classes and ALF classes all take several values.
Active deblocking edges are 16 samples apart (8 in subsampled chroma), as
the max-filter-length rules keep real edges: no sample is written by two
edges.  The MC, DMVR, FIR and BDOF cases use VTM's own filter tables
(ops/mc.py) and put windows across every plane edge.
"""

from __future__ import annotations

import os

import numpy as np

from vtm_tpu_torch.ops import mc as MC
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


def mc_tiles_case(rng, refs: np.ndarray, n: int, lum: bool, bd: int,
                  cover: bool = False) -> tuple:
    """(r_idx, x0, y0, cH, cV, fy_nz, rnd) of n MC tiles over the planes
    refs [R, H, W], uni and bi, each phase zero about a quarter of the time.

    Tiles sit anywhere on the plane (cover=False) or cover it in raster
    order, again and again (cover=True: n = k times the plane's tile
    count covers it k times); each is moved by an MV wide enough that
    windows run off every edge of the plane."""
    R, H, W = refs.shape
    taps, tile = (8, 4) if lum else (4, 2)
    table = MC._LUMA if lum else MC._CHROMA
    if cover:
        by, bx = np.divmod(np.arange(n) % ((H // tile) * (W // tile)), W // tile)
        bx, by = bx * tile, by * tile
    else:
        bx, by = rng.integers(0, W, n), rng.integers(0, H, n)
    reach = 2 * (tile + taps)
    x0 = bx + rng.integers(-reach, reach + 1, n) - (taps // 2 - 1)
    y0 = by + rng.integers(-reach, reach + 1, n) - (taps // 2 - 1)
    fx = np.where(rng.random(n) < 0.25, 0, rng.integers(0, len(table), n))
    fy = np.where(rng.random(n) < 0.25, 0, rng.integers(0, len(table), n))
    ints = (rng.integers(0, R, n), x0, y0, table[fx], table[fy])
    return tuple(a.astype(np.int32) for a in ints) + (fy != 0, rng.random(n) < 0.5)


def _dmvr_crafted(dx: int, dy: int) -> list[tuple]:
    """Search windows whose costs are known (integer phases, so the grid is
    the window itself): the biased centre tying the minimum, a five-way tie
    away from the centre, and an early termination."""
    ph, pw = dy + 7, dx + 7
    zero = np.zeros((ph, pw), np.int32)
    cases = []
    for odd in (75, 50):
        # g0 rows y: f(y); g1 = 0.  cost(dmx, dmy) = dx * sum over the even
        # rows r of f(2 + dmy + r): the dmy = 0 row costs 100 per sample,
        # dmy = -1 costs `odd` (75: exactly the centre's 3/4 bias, a tie;
        # 50: below it, five offsets tie), the others far more.
        f = np.where(np.arange(dy + 4) % 2 == 0, 100, odd)
        f[[0, dy + 1, dy + 2, dy + 3]] = 1000
        pre0 = zero.copy()
        pre0[1:1 + dy + 4, 1:1 + dx + 4] = f[:, None]
        cases.append((pre0, zero.copy()))
    flat = np.full((ph, pw), 100, np.int32)
    cases.append((flat, flat.copy()))
    return [(p0, p1, 0, 0, 0, 0) for p0, p1 in cases]


def dmvr_case(rng, n: int, dx: int, dy: int, bd: int) -> tuple:
    """(pre0, pre1, f0x, f0y, f1x, f1y) of n DMVR sub-PUs: the three crafted
    ones of _dmvr_crafted, then windows cut from one blocky plane at small
    relative shifts (so the best offset varies) with random phases."""
    ph, pw = dy + 7, dx + 7
    crafted = _dmvr_crafted(dx, dy)
    m = n - len(crafted)
    base = plane(rng, ph + 8, (pw + 8) * m, bd).reshape(ph + 8, m, pw + 8)
    base = base.transpose(1, 0, 2)
    s0 = rng.integers(0, 5, (m, 2))
    s1 = rng.integers(0, 5, (m, 2))
    idx = np.arange(m)[:, None, None]
    rows, cols = np.arange(ph)[None, :, None], np.arange(pw)[None, None, :]
    pre0 = base[idx, s0[:, :1, None] + 2 + rows, s0[:, 1:, None] + 2 + cols]
    pre1 = base[idx, s1[:, :1, None] + 2 + rows, s1[:, 1:, None] + 2 + cols]
    fr = [np.where(rng.random(m) < 0.25, 0, rng.integers(0, 16, m)) for _ in range(4)]
    out = [np.concatenate([np.stack([c[k] for c in crafted]), a])
           for k, a in enumerate((pre0, pre1))]
    out += [np.concatenate([[c[2 + k] for c in crafted], f]) for k, f in enumerate(fr)]
    return tuple(a.astype(np.int32) for a in out)


def fir_blocks_case(rng, n: int, taps: int, w: int, h: int, bd: int) -> tuple:
    """(bufs, x0, y0, cfh, cfv) of n blocks with private buffers the size of
    DMVR's ((h + taps - 1) x (w + taps - 1)); origins reach past every
    buffer edge."""
    table = MC._LUMA if taps == 8 else MC._CHROMA
    bufs = rng.integers(0, 1 << bd, (n, h + taps - 1, w + taps - 1))
    half = taps // 2 - 1
    x0 = rng.integers(-2, 2 * half + 3, n)
    y0 = rng.integers(-2, 2 * half + 3, n)
    cfh = table[rng.integers(0, len(table), n)]
    cfv = table[rng.integers(0, len(table), n)]
    return tuple(a.astype(np.int32) for a in (bufs, x0, y0, cfh, cfv))


def bdof_case(rng, n: int, w: int, h: int, bd: int) -> tuple:
    """(p0e, p1e) extended predictions [n, h+2, w+2] in the 14-bit domain:
    half the blocks are smooth ramps seen at two small shifts (moderate
    flow), half random over the whole domain (the largest gradients)."""
    lo, hi = -(1 << 13), (1 << 14) + (1 << 13)
    yy, xx = np.mgrid[0:h + 2, 0:w + 2]
    m = n // 2
    a = rng.integers(-600, 601, (m, 1, 1))
    b = rng.integers(-600, 601, (m, 1, 1))
    c = rng.integers(0, 1 << 14, (m, 1, 1))
    d = rng.integers(-2, 3, (2, m, 1, 1))
    smooth0 = a * xx + b * yy + c
    smooth1 = a * (xx + d[0]) + b * (yy + d[1]) + c
    noise = rng.integers(-64, 65, (2, m, h + 2, w + 2))
    wild = rng.integers(lo, hi, (2, n - m, h + 2, w + 2))
    p0 = np.concatenate([np.clip(smooth0 + noise[0], lo, hi), wild[0]])
    p1 = np.concatenate([np.clip(smooth1 + noise[1], lo, hi), wild[1]])
    return p0.astype(np.int32), p1.astype(np.int32)


# ---------------------------------------------------------------------------
# encoder inputs

TESTDATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "testdata")


def read_source(name: str, w: int, h: int, frame: int = 0, bit_depth: int = 8):
    """Frame `frame` of testdata/<name>.yuv (4:2:0) as int32 planes."""
    from vtm_tpu_torch.common.types import ChromaFormat
    from vtm_tpu_torch.utils.yuv_io import YuvFormat, read_yuv

    fmt = YuvFormat(w, h, ChromaFormat.YUV420, bit_depth)
    frames = read_yuv(os.path.join(TESTDATA, f"{name}.yuv"), fmt, frame + 1)
    return [p.astype(np.int32) for p in frames[frame]]


def hd_source(frame: int = 0, w: int = 1920, h: int = 1080):
    """A w x h 4:2:0 8-bit picture (1920x1080 by default) mirror-tiled from
    frame `frame` of testdata/bq416_416x240_420_8.yuv: natural content with
    no seams, for the encoder at its north-star size (no 1080p source is in
    the repo)."""
    planes = read_source("bq416_416x240_420_8", 416, 240, frame)
    out = []
    for c, p in enumerate(planes):
        ph, pw = (h, w) if c == 0 else (h // 2, w // 2)
        out.append(np.pad(p, ((0, ph - p.shape[0]), (0, pw - p.shape[1])),
                          mode="symmetric"))
    return out


def satd_diffs(rng, n: int, h: int, w: int, bit_depth: int) -> np.ndarray:
    """n difference blocks (n, h, w) of two bit_depth pictures: random, with
    the first blocks at the extremes (all +max, all -max, a +-max
    checkerboard) that give each tile kind its largest sums."""
    maxv = (1 << bit_depth) - 1
    d = rng.integers(-maxv, maxv + 1, size=(n, h, w))
    ext = [np.full((h, w), maxv), np.full((h, w), -maxv),
           np.where((np.arange(h)[:, None] + np.arange(w)) % 2 == 0, maxv, -maxv)]
    k = min(n, len(ext))
    d[:k] = np.stack(ext[:k])
    return d.astype(np.int32)


def rmd_source(rng, h: int, w: int, bit_depth: int) -> np.ndarray:
    """A blocky bit_depth source plane with flat runs (so RMD costs tie)
    and samples at both ends of the range."""
    p = plane(rng, h, w, bit_depth)
    p[: h // 4, : w // 4] = (1 << bit_depth) - 1
    p[h // 2:, w // 2:] = p[h // 2, w // 2]
    return p


def rmd_positions(rng, n: int, pic_w: int, pic_h: int, w: int, h: int):
    """n block positions (xs, ys) of a w x h class on a pic_w x pic_h
    picture, on the class's grid and including both corners."""
    from vtm_tpu_torch.encoder.rmd import _class_strides

    sx, sy = _class_strides(w, h)
    xs = rng.integers(0, (pic_w - w) // sx + 1, n) * sx
    ys = rng.integers(0, (pic_h - h) // sy + 1, n) * sy
    xs[0], ys[0] = 0, 0
    xs[-1], ys[-1] = (pic_w - w) // sx * sx, (pic_h - h) // sy * sy
    return xs.astype(np.int32), ys.astype(np.int32)


def satd_f32_cases(rng, th: int, tw: int, bit_depth: int, n_try: int = 40_000):
    """Difference tiles (n, th, tw) of a 16x8 / 8x16 / 8x4 / 4x8 tile kind on
    which jax's float32 normalisation int(f32(s) * f32(2 / sqrt(th tw)))
    and the float64 one of numpy's satd_batch give different integers
    (about one tile in a thousand), found among n_try random tiles."""
    import math

    from vtm_tpu_torch.ops import rdcost

    maxv = (1 << bit_depth) - 1
    d = rng.integers(-maxv, maxv + 1, size=(n_try, th, tw)).astype(np.int64)
    s = rdcost._tile_satd_sum(d, th, tw)
    norm = 2.0 / math.sqrt(th * tw)
    f32 = (s.astype(np.float32) * np.float32(norm)).astype(np.int64)
    f64 = (s.astype(np.float64) * norm).astype(np.int64)
    return d[f32 != f64].astype(np.int32)
