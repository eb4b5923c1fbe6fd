"""ALF: classification, clipped diamond filter and CC-ALF — plain torch
versions + CUDA wrappers — and the host-side virtual-boundary row tables.

Counterpart of vtm_tpu/ops/alf_kernel.py.  The row-table helpers are numpy
copies of the reference's (they must not pull in jax); the kernels take the
jax functions' arguments and give the same int32 results.

* CPU tensors: `classify_picture_plain`, `alf_filter_plain`,
  `ccalf_filter_plain`.
* CUDA tensors: the three kernels of csrc/alf.cu.

`alf_all` composes them as the reference does (one call per picture):
classification, the per-CTU coefficient gather cperm[ctu_of, cls, tr],
the luma and chroma filters, and CC-ALF from the pre-ALF luma.
"""

from __future__ import annotations

import numpy as np
import torch

from vtm_tpu_torch import kernels as KN
from vtm_tpu_torch.ops import clamp_index, clip3, edge_pad, mul32, where

PAD = 4
ACT_TH = np.array([0, 1, 2, 2, 2, 2, 2, 3, 3, 3, 3, 3, 3, 3, 3, 4],
                  dtype=np.int32)
TRANSPOSE_TABLE = np.array([0, 1, 0, 2, 2, 3, 1, 3], dtype=np.int32)

LUMA_TAPS = ((5, 0), (3, 1), (3, 0), (3, -1), (1, 2), (1, 1), (1, 0),
             (1, -1), (1, -2), (0, 3), (0, 2), (0, 1))
CHROMA_TAPS = ((3, 0), (1, 1), (1, 0), (1, -1), (0, 2), (0, 1))


# ---------------------------------------------------------------------------
# host-side VB row preparation (numpy)
# ---------------------------------------------------------------------------

def vb_row_offsets(h: int, vb_ctu_height: int, vb_pos: int, is_luma: bool):
    """Per-row (o1..o6) tap row offsets + near_vb flag (filterBlk VB logic)."""
    o = np.zeros((h, 6), dtype=np.int32)
    near = np.zeros(h, dtype=bool)
    rng = 4 if is_luma else 2
    for y in range(h):
        yvb = y & (vb_ctu_height - 1)
        o1, o2, o3, o4, o5, o6 = 1, -1, 2, -2, 3, -3
        if yvb < vb_pos and yvb >= vb_pos - rng:
            if yvb == vb_pos - 1:
                o1 = o2 = 0
            if yvb >= vb_pos - 2:
                o3, o4 = o1, o2
            if yvb >= vb_pos - 3:
                o5, o6 = o3, o4
        elif vb_pos <= yvb <= vb_pos + (3 if is_luma else 1):
            if yvb == vb_pos:
                o1 = o2 = 0
            if yvb <= vb_pos + 1:
                o3, o4 = o1, o2
            if yvb <= vb_pos + 2:
                o5, o6 = o3, o4
        o[y] = (o1, o2, o3, o4, o5, o6)
        near[y] = yvb in (vb_pos - 1, vb_pos)
    return o, near


def classify_row_indices(h: int, vb_ctu_height: int, vb_pos: int):
    """VB-adjusted (yd, yu, yu2) padded-row indices per even laplacian row."""
    nr = h // 2 + 2
    y_i = np.zeros(nr, dtype=np.int32)
    yd_i = np.zeros(nr, dtype=np.int32)
    yu_i = np.zeros(nr, dtype=np.int32)
    yu2_i = np.zeros(nr, dtype=np.int32)
    for gy in range(nr):
        y = 2 * gy - 2
        yd, yu, yu2 = y - 1, y + 1, y + 2
        if y > 0 and (y & (vb_ctu_height - 1)) == vb_pos - 2:
            yu2 = yu
        elif y > 0 and (y & (vb_ctu_height - 1)) == vb_pos:
            yd = y
        y_i[gy] = y + PAD
        yd_i[gy] = yd + PAD
        yu_i[gy] = yu + PAD
        yu2_i[gy] = yu2 + PAD
    return y_i, yd_i, yu_i, yu2_i


def classify_block_rows(h: int, vb_ctu_height: int, vb_pos: int):
    """Per 4x4-block-row: (drop_first, drop_last, mult) of the class sums."""
    nb = h // 4
    drop_first = np.zeros(nb, dtype=bool)
    drop_last = np.zeros(nb, dtype=bool)
    mult = np.full(nb, 64, dtype=np.int32)
    for by in range(nb):
        y = by * 4
        yv = y % vb_ctu_height
        if yv == vb_pos - 4:
            drop_last[by] = True
        elif yv == vb_pos:
            drop_first[by] = True
        yb = y & (vb_ctu_height - 1)
        if yb in (vb_pos - 4, vb_pos):
            mult[by] = 96
    return drop_first, drop_last, mult


def ccalf_row_offsets(hc: int, scale_y: int, vb_ctu_height: int, vb_pos: int):
    """Per chroma row: (o1, o2, o3) luma tap offsets + skip flag."""
    o = np.zeros((hc, 3), dtype=np.int32)
    skip = np.zeros(hc, dtype=bool)
    for i in range(hc):
        pos = (i << scale_y) & (vb_ctu_height - 1)
        if scale_y == 0 and (pos == vb_pos or pos == vb_pos + 1):
            skip[i] = True
        o1, o2, o3 = 1, -1, 2
        if pos == vb_pos - 2 or pos == vb_pos + 1:
            o3 = o1
        elif pos == vb_pos - 1 or pos == vb_pos:
            o1 = o2 = o3 = 0
        o[i] = (o1, o2, o3)
    return o, skip


# ---------------------------------------------------------------------------
# plain torch versions
# ---------------------------------------------------------------------------

def _rows(pad, idx):
    """pad[idx] with the row index clamped, as a jax gather clamps it."""
    return pad[clamp_index(idx, pad.shape[0])]


def classify_picture_plain(pad, y_i, yd_i, yu_i, yu2_i, drop_first, drop_last,
                           mult, bit_depth: int):
    """deriveClassificationBlk over the whole picture; pad is the luma plane
    padded by PAD.  Returns (classes, transposes) int32 [H4, W4]."""
    shift = bit_depth + 4
    Hp, Wp = pad.shape
    w = Wp - 2 * PAD
    NW = w // 2 + 2

    Ry, Rd, Ru, Ru2 = (_rows(pad, i) for i in (y_i, yd_i, yu_i, yu2_i))

    def cols(R, dx):
        # even columns x = 2*gx - 2 + dx  ->  padded col = 2*gx + 2 + dx
        return R[:, 2 + dx:2 + dx + 2 * NW:2]

    y0v = cols(Ry, 0) * 2
    yup1 = cols(Ru, 1) * 2
    V = torch.abs(y0v - cols(Rd, 0) - cols(Ru, 0)) \
        + torch.abs(yup1 - cols(Ry, 1) - cols(Ru2, 1))
    Hh = torch.abs(y0v - cols(Ry, 1) - cols(Ry, -1)) \
        + torch.abs(yup1 - cols(Ru, 2) - cols(Ru, 0))
    D0 = torch.abs(y0v - cols(Rd, -1) - cols(Ru, 1)) \
        + torch.abs(yup1 - cols(Ry, 0) - cols(Ru2, 2))
    D1 = torch.abs(y0v - cols(Ru, -1) - cols(Rd, 1)) \
        + torch.abs(yup1 - cols(Ru2, 0) - cols(Ry, 2))

    H4 = (y_i.shape[0] - 2) // 2
    W4 = (NW - 2) // 2

    def block_sum(A):
        C = A[:, 0:-3] + A[:, 1:-2] + A[:, 2:-1] + A[:, 3:]
        C = C[:, 0:2 * W4:2]
        R = [C[a:a + 2 * H4:2] for a in range(4)]
        full = R[0] + R[1] + R[2] + R[3]
        nolast = R[0] + R[1] + R[2]
        nofirst = R[1] + R[2] + R[3]
        return torch.where(drop_last[:, None], nolast,
                           torch.where(drop_first[:, None], nofirst, full))

    sum_v = block_sum(V)
    sum_h = block_sum(Hh)
    sum_d0 = block_sum(D0)
    sum_d1 = block_sum(D1)

    dev = pad.device
    act_th = torch.from_numpy(ACT_TH).to(dev)
    tr_table = torch.from_numpy(TRANSPOSE_TABLE).to(dev)
    activity = (mul32(sum_v + sum_h, mult[:, None]) >> shift).clamp(0, 15)
    class_idx = act_th[activity.long()]

    hv_gt = sum_v > sum_h
    hv1 = torch.where(hv_gt, sum_v, sum_h)
    hv0 = torch.where(hv_gt, sum_h, sum_v)
    dir_hv = where(hv_gt, 1, 3)
    d_gt = sum_d0 > sum_d1
    d1 = torch.where(d_gt, sum_d0, sum_d1)
    d0 = torch.where(d_gt, sum_d1, sum_d0)
    dir_d = where(d_gt, 0, 2)
    # int32 products that wrap, as the reference's plain-int arithmetic
    dmain = mul32(d1, hv0) > mul32(hv1, d0)
    hvd1 = torch.where(dmain, d1, hv1)
    hvd0 = torch.where(dmain, d0, hv0)
    main_dir = torch.where(dmain, dir_d, dir_hv)
    sec_dir = torch.where(dmain, dir_hv, dir_d)
    strength = where(hvd1 * 2 > 9 * hvd0, 2, where(hvd1 > 2 * hvd0, 1, 0))
    class_idx = torch.where(
        strength > 0,
        class_idx + (((main_dir & 1) << 1) + strength) * 5,
        class_idx)
    transposes = tr_table[clamp_index(main_dir * 2 + (sec_dir >> 1), 8)]
    return class_idx.to(torch.int32), transposes.to(torch.int32)


def _expand4(m):
    """[H4, W4] -> [H, W], each value over its 4x4 block."""
    return m.repeat_interleave(4, dim=0).repeat_interleave(4, dim=1)


def alf_filter_plain(src_pad, coefmap, clipmap, o_rows, near_vb, taps,
                     bit_depth: int):
    """Clipped diamond filter over a whole plane.

    src_pad: int32 [H+2P, W+2P]; coefmap/clipmap: int32 [H4, W4, n_taps]
    (zero coefficients: identity); o_rows: int32 [H, 6] VB-adjusted row
    offsets; near_vb: bool [H]."""
    shift = 8 - 1  # NUM_BITS - 1
    offset = 1 << (shift - 1)
    maxv = (1 << bit_depth) - 1
    H = o_rows.shape[0]
    W = coefmap.shape[1] * 4
    yy = torch.arange(H, device=src_pad.device)
    curr = src_pad[PAD:PAD + H, PAD:PAD + W]

    rows_a = {0: _rows(src_pad, yy + PAD)}
    rows_b = {0: rows_a[0]}
    for op, (ia, ib) in ((1, (0, 1)), (3, (2, 3)), (5, (4, 5))):
        rows_a[op] = _rows(src_pad, yy + PAD + o_rows[:, ia])
        rows_b[op] = _rows(src_pad, yy + PAD + o_rows[:, ib])

    acc = torch.zeros((H, W), dtype=torch.int32, device=src_pad.device)
    for k, (op, dx) in enumerate(taps):
        a = rows_a[op][:, PAD + dx:PAD + dx + W]
        b = rows_b[op][:, PAD - dx:PAD - dx + W]
        cl = _expand4(clipmap[:, :, k])
        co = _expand4(coefmap[:, :, k])
        d = clip3(-cl, cl, a - curr) + clip3(-cl, cl, b - curr)
        acc = acc + co * d
    acc = torch.where(
        near_vb[:, None],
        (acc + (1 << (shift + 3 - 1))) >> (shift + 3),
        (acc + offset) >> shift)
    return (curr + acc).clamp(0, maxv)


def ccalf_filter_plain(luma_pad, dst, coefmap, o_rows, skip,
                       scale_x: int, scale_y: int, bit_depth: int):
    """filterBlkCcAlf over a whole chroma plane.

    luma_pad: int32 pre-ALF luma padded by PAD; dst: int32 [Hc, Wc] chroma
    (after chroma ALF); coefmap: int32 [Hc4, Wc4, 7] (zeros: identity);
    o_rows: [Hc, 3]; skip: bool [Hc]."""
    maxv = (1 << bit_depth) - 1
    half = (1 << bit_depth) >> 1
    Hc, Wc = dst.shape
    yy = torch.arange(Hc, device=dst.device)
    yl = (yy << scale_y) + PAD

    R0 = _rows(luma_pad, yl)
    R1 = _rows(luma_pad, yl + o_rows[:, 0])
    R2 = _rows(luma_pad, yl + o_rows[:, 1])
    R3 = _rows(luma_pad, yl + o_rows[:, 2])

    step = 1 << scale_x

    def cols(R, dx):
        return R[:, PAD + dx:PAD + dx + step * Wc:step]

    curr = cols(R0, 0)
    c = [_expand4(coefmap[:, :, k]) for k in range(7)]
    s = c[0] * (cols(R2, 0) - curr)
    s = s + c[1] * (cols(R0, -1) - curr)
    s = s + c[2] * (cols(R0, 1) - curr)
    s = s + c[3] * (cols(R1, -1) - curr)
    s = s + c[4] * (cols(R1, 0) - curr)
    s = s + c[5] * (cols(R1, 1) - curr)
    s = s + c[6] * (cols(R3, 0) - curr)
    s = (s + ((1 << 7) >> 1)) >> 7  # SCALE_BITS_CC
    # ClipPel(sum + offset) - offset (AdaptiveLoopFilter.cpp:1399)
    s = (s + half).clamp(0, maxv) - half
    out = (s + dst).clamp(0, maxv)
    return torch.where(skip[:, None], dst, out)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

def classify_picture_cuda(pad, y_i, yd_i, yu_i, yu2_i, drop_first, drop_last,
                          mult, bit_depth: int):
    dev = pad.device
    Hp, Wp = pad.shape
    nr = y_i.shape[0]
    H4, W4 = (nr - 2) // 2, (Wp - 2 * PAD) // 4
    KN.check(pad, "pad", torch.int32, dev)
    for name, t in (("y_i", y_i), ("yd_i", yd_i), ("yu_i", yu_i),
                    ("yu2_i", yu2_i)):
        KN.check(t, name, torch.int32, dev, (nr,))
    KN.check(drop_first, "drop_first", torch.bool, dev, (H4,))
    KN.check(drop_last, "drop_last", torch.bool, dev, (H4,))
    KN.check(mult, "mult", torch.int32, dev, (H4,))
    cls = torch.empty((H4, W4), dtype=torch.int32, device=dev)
    tr = torch.empty((H4, W4), dtype=torch.int32, device=dev)
    KN.launch("vtm_alf_classify", dev, pad.data_ptr(), Hp, Wp,
              y_i.data_ptr(), yd_i.data_ptr(), yu_i.data_ptr(),
              yu2_i.data_ptr(), nr, drop_first.data_ptr(),
              drop_last.data_ptr(), mult.data_ptr(), H4, W4, bit_depth,
              cls.data_ptr(), tr.data_ptr())
    return cls, tr


def alf_filter_cuda(src_pad, coefmap, clipmap, o_rows, near_vb, taps,
                    bit_depth: int):
    if taps not in (LUMA_TAPS, CHROMA_TAPS):
        raise ValueError("alf_filter: taps must be LUMA_TAPS or CHROMA_TAPS")
    dev = src_pad.device
    Hp, Wp = src_pad.shape
    H = o_rows.shape[0]
    H4, W4, n = coefmap.shape
    if n != len(taps) or H4 * 4 != H:
        raise ValueError(f"alf_filter: coefmap {tuple(coefmap.shape)} does "
                         f"not fit {H} rows and {len(taps)} taps")
    KN.check(src_pad, "src_pad", torch.int32, dev)
    KN.check(coefmap, "coefmap", torch.int32, dev)
    KN.check(clipmap, "clipmap", torch.int32, dev, (H4, W4, n))
    KN.check(o_rows, "o_rows", torch.int32, dev, (H, 6))
    KN.check(near_vb, "near_vb", torch.bool, dev, (H,))
    out = torch.empty((H, W4 * 4), dtype=torch.int32, device=dev)
    KN.launch("vtm_alf_filter", dev, src_pad.data_ptr(), Hp, Wp,
              coefmap.data_ptr(), clipmap.data_ptr(), int(taps == LUMA_TAPS),
              o_rows.data_ptr(), near_vb.data_ptr(), H, W4 * 4, bit_depth,
              out.data_ptr())
    return out


def ccalf_filter_cuda(luma_pad, dst, coefmap, o_rows, skip, scale_x: int,
                      scale_y: int, bit_depth: int):
    dev = dst.device
    Hp, Wp = luma_pad.shape
    Hc, Wc = dst.shape
    KN.check(luma_pad, "luma_pad", torch.int32, dev)
    KN.check(dst, "dst", torch.int32, dev)
    KN.check(coefmap, "coefmap", torch.int32, dev, (Hc // 4, Wc // 4, 7))
    KN.check(o_rows, "o_rows", torch.int32, dev, (Hc, 3))
    KN.check(skip, "skip", torch.bool, dev, (Hc,))
    if Hc % 4 or Wc % 4:
        raise ValueError(f"ccalf_filter: chroma plane {Hc}x{Wc} is not a "
                         "multiple of 4")
    out = torch.empty_like(dst)
    KN.launch("vtm_ccalf_filter", dev, luma_pad.data_ptr(), Hp, Wp,
              dst.data_ptr(), coefmap.data_ptr(), o_rows.data_ptr(),
              skip.data_ptr(), Hc, Wc, scale_x, scale_y, bit_depth,
              out.data_ptr())
    return out


# ---------------------------------------------------------------------------
# dispatch: CUDA tensor -> kernel, CPU tensor -> plain version
# ---------------------------------------------------------------------------

def classify_picture(pad, y_i, yd_i, yu_i, yu2_i, drop_first, drop_last, mult,
                     bit_depth: int):
    fn = classify_picture_cuda if pad.is_cuda else classify_picture_plain
    return fn(pad, y_i, yd_i, yu_i, yu2_i, drop_first, drop_last, mult,
              bit_depth=bit_depth)


def alf_filter(src_pad, coefmap, clipmap, o_rows, near_vb, taps,
               bit_depth: int):
    fn = alf_filter_cuda if src_pad.is_cuda else alf_filter_plain
    return fn(src_pad, coefmap, clipmap, o_rows, near_vb, taps=taps,
              bit_depth=bit_depth)


def ccalf_filter(luma_pad, dst, coefmap, o_rows, skip, scale_x: int,
                 scale_y: int, bit_depth: int):
    fn = ccalf_filter_cuda if luma_pad.is_cuda else ccalf_filter_plain
    return fn(luma_pad, dst, coefmap, o_rows, skip, scale_x=scale_x,
              scale_y=scale_y, bit_depth=bit_depth)


def _alf_all(classify, filt, ccalf, y_pad, cb, cr,
             cperm, lperm, ctu_of, l_orows, l_near,
             y_i, yd_i, yu_i, yu2_i, df, dl, mult,
             cb_coef, cb_clip, cr_coef, cr_clip, c_orows, c_near,
             cc1_coef, cc2_coef, cc_orows, cc_skip,
             bit_depth, sx, sy, has_l, has_cb, has_cr, has_cc1, has_cc2):
    if has_l:
        cls, tr = classify(y_pad, y_i, yd_i, yu_i, yu2_i, df, dl, mult,
                           bit_depth=bit_depth)
        n_ctu, n_cls, n_tr = cperm.shape[:3]
        gather = (clamp_index(ctu_of, n_ctu), clamp_index(cls, n_cls),
                  clamp_index(tr, n_tr))
        y = filt(y_pad, cperm[gather], lperm[gather], l_orows, l_near,
                 taps=LUMA_TAPS, bit_depth=bit_depth)
    else:
        y = y_pad[PAD:-PAD, PAD:-PAD]
    if has_cb:
        cb = filt(edge_pad(cb, PAD, PAD), cb_coef, cb_clip, c_orows, c_near,
                  taps=CHROMA_TAPS, bit_depth=bit_depth)
    if has_cr:
        cr = filt(edge_pad(cr, PAD, PAD), cr_coef, cr_clip, c_orows, c_near,
                  taps=CHROMA_TAPS, bit_depth=bit_depth)
    if has_cc1:
        cb = ccalf(y_pad, cb, cc1_coef, cc_orows, cc_skip, scale_x=sx,
                   scale_y=sy, bit_depth=bit_depth)
    if has_cc2:
        cr = ccalf(y_pad, cr, cc2_coef, cc_orows, cc_skip, scale_x=sx,
                   scale_y=sy, bit_depth=bit_depth)
    return y, cb, cr


def alf_all_plain(y_pad, cb, cr, *tables, bit_depth: int, sx: int, sy: int,
                  has_l: bool, has_cb: bool, has_cr: bool, has_cc1: bool,
                  has_cc2: bool):
    """The jax alf_all in plain torch ops, on any device."""
    return _alf_all(classify_picture_plain, alf_filter_plain,
                    ccalf_filter_plain, y_pad, cb, cr, *tables,
                    bit_depth, sx, sy, has_l, has_cb, has_cr, has_cc1, has_cc2)


def alf_all(y_pad, cb, cr, *tables, bit_depth: int, sx: int, sy: int,
            has_l: bool, has_cb: bool, has_cr: bool, has_cc1: bool,
            has_cc2: bool):
    """Whole-picture ALF: classification, luma filter with the per-CTU
    coefficient gather, chroma ALF and CC-ALF (from the pre-ALF luma);
    through the CUDA kernels for CUDA tensors."""
    return _alf_all(classify_picture, alf_filter, ccalf_filter, y_pad, cb, cr,
                    *tables, bit_depth, sx, sy, has_l, has_cb, has_cr,
                    has_cc1, has_cc2)
