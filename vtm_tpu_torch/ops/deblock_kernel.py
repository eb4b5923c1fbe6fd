"""Deblocking of one edge direction: plain torch version + CUDA wrapper.

Counterpart of vtm_tpu/ops/deblock_kernel.py.  `deblock_dir` takes the jax
function's arguments (planes, the 17 per-segment maps on the 4x4 luma grid
in picture orientation, static flags) and returns the filtered planes.

* CPU tensors: `deblock_dir_plain`, a line-by-line translation of the jax
  kernel (dense over the segment grid: `luma_ver_delta`, `chroma_ver_core`).
* CUDA tensors: csrc/deblock.cu, one launch for luma and one for Cb and Cr
  together; HOR passes the transposed strides of the planes and maps
  instead of copying (the kernels tile the plane in its own layout).

`luma_ver_delta` (deblock_kernel.py:68) is also an entry of its own, for
width sharding: the deltas over a plane extended by 8 columns each side
(`luma_ver_delta_plain`; csrc/deblock.cu `vtm_deblock_luma_ver_delta`).
"""

from __future__ import annotations

import ctypes

import torch

from vtm_tpu_torch import kernels as KN
from vtm_tpu_torch.ops import clip3, edge_pad, pick, where

# position-coefficient tables of xFilteringPandQ (LoopFilter.cpp)
_DB7 = (59, 50, 41, 32, 23, 14, 5)
_DB5 = (58, 45, 32, 19, 6, 0, 0)
_DB3 = (53, 32, 11, 0, 0, 0, 0)
_TC7 = (6, 5, 4, 3, 2, 1, 1)
_TC3 = (6, 4, 2, 0, 0, 0, 0)

N_MAPS = 17


def luma_ver_delta_plain(pad, active, tc, beta, max_p, max_q, no_p, no_q,
                         bit_depth: int):
    """Delta of the vertical luma edge filter over `pad` (the plane extended
    by 8 columns each side: edge-replicated at the picture border, the
    neighbours' halo under sharding), as in the jax kernel; the deltas that
    fall into the halo belong to the neighbouring shard."""
    H, Wp = pad.shape
    W = Wp - 16
    H4, W4 = H // 4, W // 4
    maxv = (1 << bit_depth) - 1
    dev = pad.device

    ys = (torch.arange(H4, device=dev) * 4)[:, None] + torch.arange(4, device=dev)[None, :]
    xs = (torch.arange(W4, device=dev) * 4)[:, None] + torch.arange(16, device=dev)[None, :]
    Wn = pad[ys[:, None, :, None], xs[None, :, None, :]]  # [H4,W4,4,16]

    def s(line, i):
        return Wn[:, :, line, 8 + i]

    side_p = max_p > 3
    side_q = max_q > 3

    def calc_dp(line, off=0):
        return torch.abs(s(line, -3 + off) - 2 * s(line, -2 + off) + s(line, -1 + off))

    def calc_dq(line, off=0):
        return torch.abs(s(line, 0 + off) - 2 * s(line, 1 + off) + s(line, 2 + off))

    dp0, dq0 = calc_dp(0), calc_dq(0)
    dp3, dq3 = calc_dp(3), calc_dq(3)
    dp0l = torch.where(side_p, (dp0 + calc_dp(0, -3) + 1) >> 1, dp0)
    dp3l = torch.where(side_p, (dp3 + calc_dp(3, -3) + 1) >> 1, dp3)
    dq0l = torch.where(side_q, (dq0 + calc_dq(0, 3) + 1) >> 1, dq0)
    dq3l = torch.where(side_q, (dq3 + calc_dq(3, 3) + 1) >> 1, dq3)

    def use_strong_plain(line, d):
        m4, m3, m7, m0 = s(line, 0), s(line, -1), s(line, 3), s(line, -4)
        return (
            ((torch.abs(m0 - m3) + torch.abs(m7 - m4)) < (beta >> 3))
            & (d < (beta >> 2))
            & (torch.abs(m3 - m4) < ((tc * 5 + 1) >> 1))
        )

    def use_strong_large(line, d):
        m4, m3, m7, m0 = s(line, 0), s(line, -1), s(line, 3), s(line, -4)
        sp3_base = torch.abs(m0 - m3)
        sq3_base = torch.abs(m7 - m4)
        sp3_l = torch.where(
            max_p == 7,
            sp3_base + torch.abs(s(line, -5) - s(line, -6) - s(line, -7) + s(line, -8)),
            sp3_base)
        mp4 = torch.where(max_p == 7, s(line, -8), s(line, -6))
        sp3_l = (sp3_l + torch.abs(m0 - mp4) + 1) >> 1
        sp3_l = torch.where(side_p, sp3_l, sp3_base)
        sq3_l = torch.where(
            max_q == 7,
            sq3_base + torch.abs(s(line, 4) - s(line, 5) - s(line, 6) + s(line, 7)),
            sq3_base)
        m11 = torch.where(max_q == 7, s(line, 7), s(line, 5))
        sq3_l = (sq3_l + torch.abs(m11 - m7) + 1) >> 1
        sq3_l = torch.where(side_q, sq3_l, sq3_base)
        return (
            ((sp3_l + sq3_l) < (beta * 3 >> 5))
            & (d < (beta >> 4))
            & (torch.abs(m3 - m4) < ((tc * 5 + 1) >> 1))
        )

    # long (large-side) path
    dl = (dp0l + dq0l) + (dp3l + dq3l)
    side_thresh = (beta + (beta >> 1)) >> 3
    swl = use_strong_large(0, 2 * (dp0l + dq0l)) & use_strong_large(3, 2 * (dp3l + dq3l))
    use_long = (side_p | side_q) & (dl < beta) & swl

    n_p = torch.where(side_p, max_p, 3)
    n_q = torch.where(side_q, max_q, 3)

    def sv(i):  # all 4 lines at offset i: [H4,W4,4]
        return Wn[:, :, :, 8 + i]

    def e(a):  # segment value over its lines
        return a[:, :, None]

    ref_p = torch.where(
        e(n_p == 7), (sv(-7) + sv(-8) + 1) >> 1,
        torch.where(e(n_p == 3), (sv(-3) + sv(-4) + 1) >> 1, (sv(-5) + sv(-6) + 1) >> 1))
    ref_q = torch.where(
        e(n_q == 7), (sv(6) + sv(7) + 1) >> 1,
        torch.where(e(n_q == 3), (sv(2) + sv(3) + 1) >> 1, (sv(4) + sv(5) + 1) >> 1))
    mid_55 = (2 * (sv(-1) + sv(0) + sv(-2) + sv(1) + sv(-3) + sv(2))
              + sv(-4) + sv(3) + sv(-5) + sv(4) + 8) >> 4
    mid_77 = (2 * (sv(-1) + sv(0)) + sv(-2) + sv(1) + sv(-3) + sv(2)
              + sv(-4) + sv(3) + sv(-5) + sv(4) + sv(-6) + sv(5)
              + sv(-7) + sv(6) + 8) >> 4
    mid_75 = (2 * (sv(-1) + sv(0) + sv(-2) + sv(1)) + sv(-3) + sv(2)
              + sv(-4) + sv(3) + sv(-5) + sv(4) + sv(-6) + sv(5) + 8) >> 4
    # asymmetric 7/3 (swapped-pointer form, see vtm_tpu/ops/deblock.py _filter_pq)
    mid_37 = (2 * (sv(0) + sv(-1)) + sv(-1) + 2 * (sv(-2) + sv(-3))
              + sv(1) + sv(-2) + sv(2) + sv(3) + sv(4) + sv(5) + sv(6) + 8) >> 4
    mid_73 = (2 * (sv(-1) + sv(0)) + sv(0) + 2 * (sv(1) + sv(2))
              + sv(-2) + sv(1) + sv(-3) + sv(-4) + sv(-5) + sv(-6) + sv(-7) + 8) >> 4
    mid_53 = (sv(-1) + sv(0) + sv(-2) + sv(1) + sv(-3) + sv(2)
              + sv(-4) + sv(3) + 4) >> 3
    mx = e(torch.maximum(n_p, n_q))
    mn = e(torch.minimum(n_p, n_q))
    mid = torch.where(
        e(n_p == n_q),
        torch.where(e(n_p == 5), mid_55, mid_77),
        torch.where(
            (mx == 7) & (mn == 5), mid_75,
            torch.where((mx == 7) & (mn == 3),
                        torch.where(e(n_q > n_p), mid_37, mid_73),
                        mid_53)))

    def long_val(pos, p_side):
        n = n_p if p_side else n_q
        co = where(e(n == 7), _DB7[pos], where(e(n == 5), _DB5[pos], _DB3[pos]))
        tck = where(e(n == 3), _TC3[pos], _TC7[pos])
        src = sv(-1 - pos) if p_side else sv(pos)
        cval = (e(tc) * tck) >> 1
        refs = ref_p if p_side else ref_q
        out = (mid * co + refs * (64 - co) + 32) >> 6
        return clip3(src - cval, src + cval, out)

    # short path
    d = (dp0 + dq0) + (dp3 + dq3)
    short_act = ~use_long & (d < beta)
    filter_p_s = (max_p > 1) & (max_q > 1) & ((dp0 + dp3) < side_thresh)
    filter_q_s = (max_p > 1) & (max_q > 1) & ((dq0 + dq3) < side_thresh)
    sw = (max_p > 2) & (max_q > 2) & use_strong_plain(0, 2 * (dp0 + dq0)) \
        & use_strong_plain(3, 2 * (dp3 + dq3))

    m0v, m1v, m2v, m3v = sv(-4), sv(-3), sv(-2), sv(-1)
    m4v, m5v, m6v, m7v = sv(0), sv(1), sv(2), sv(3)
    tcv = e(tc)
    st_p0 = clip3(m3v - 3 * tcv, m3v + 3 * tcv,
                  (m1v + 2 * m2v + 2 * m3v + 2 * m4v + m5v + 4) >> 3)
    st_q0 = clip3(m4v - 3 * tcv, m4v + 3 * tcv,
                  (m2v + 2 * m3v + 2 * m4v + 2 * m5v + m6v + 4) >> 3)
    st_p1 = clip3(m2v - 2 * tcv, m2v + 2 * tcv, (m1v + m2v + m3v + m4v + 2) >> 2)
    st_q1 = clip3(m5v - 2 * tcv, m5v + 2 * tcv, (m3v + m4v + m5v + m6v + 2) >> 2)
    st_p2 = clip3(m1v - tcv, m1v + tcv, (2 * m0v + 3 * m1v + m2v + m3v + m4v + 4) >> 3)
    st_q2 = clip3(m6v - tcv, m6v + tcv, (m3v + m4v + m5v + 3 * m6v + 2 * m7v + 4) >> 3)
    delta = (9 * (m4v - m3v) - 3 * (m5v - m2v) + 8) >> 4
    wk_ok = torch.abs(delta) < e(tc * 10)
    dclip = clip3(-tcv, tcv, delta)
    wk_p0 = clip3(0, maxv, m3v + dclip)
    wk_q0 = clip3(0, maxv, m4v - dclip)
    tc2 = tcv >> 1
    d1 = clip3(-tc2, tc2, (((m1v + m3v + 1) >> 1) - m2v + dclip) >> 1)
    wk_p1 = clip3(0, maxv, m2v + d1)
    d2 = clip3(-tc2, tc2, (((m6v + m4v + 1) >> 1) - m5v - dclip) >> 1)
    wk_q1 = clip3(0, maxv, m5v + d2)

    act = e(active)
    long_m = act & e(use_long)
    str_m = act & e(short_act & sw)
    wk_m = act & e(short_act & ~sw) & wk_ok
    pm = ~e(no_p)
    qm = ~e(no_q)

    out = Wn.clone()

    def put(col, mask, val):
        out[:, :, :, col] = torch.where(mask, val, out[:, :, :, col])

    for pos in range(7):
        put(8 - 1 - pos, long_m & pm & e(pos < n_p), long_val(pos, True))
        put(8 + pos, long_m & qm & e(pos < n_q), long_val(pos, False))
    for pos, val in ((-1, st_p0), (-2, st_p1), (-3, st_p2)):
        put(8 + pos, str_m & pm, val)
    for pos, val in ((0, st_q0), (1, st_q1), (2, st_q2)):
        put(8 + pos, str_m & qm, val)
    put(7, wk_m & pm, wk_p0)
    put(8, wk_m & qm, wk_q0)
    put(6, wk_m & pm & e(filter_p_s), wk_p1)
    put(9, wk_m & qm & e(filter_q_s), wk_q1)

    # overlap-sum of the per-window deltas: padded column 4q'+r' receives
    # window q'-d at tap r'+4d, d in 0..3
    delta_w = out - Wn
    acc = torch.zeros((H4, W4 + 4, 4, 4), dtype=torch.int32, device=dev)
    for dd in range(4):
        acc[:, dd:dd + W4] += delta_w[:, :, :, 4 * dd:4 * dd + 4]
    return acc.permute(0, 2, 1, 3).reshape(H, Wp)


def chroma_ver_core(plane, active, tc, beta, large, no_p, no_q, hor_ctb,
                    bit_depth: int, loop_len: int, dec_line: int):
    """Vertical chroma edge filter over the chroma segment grid [Hs, Ws]."""
    Hc, Wc = plane.shape
    Hs, Ws = Hc // loop_len, Wc // 4
    maxv = (1 << bit_depth) - 1
    dev = plane.device
    pad = edge_pad(plane, 0, 4)

    ys = (torch.arange(Hs, device=dev) * loop_len)[:, None] + torch.arange(loop_len, device=dev)[None, :]
    xs = (torch.arange(Ws, device=dev) * 4)[:, None] + torch.arange(8, device=dev)[None, :]
    Wn = pad[ys[:, None, :, None], xs[None, :, None, :]]  # [Hs,Ws,L,8]

    def s(line, i):
        return Wn[:, :, line, 4 + i]

    def sv(i):
        return Wn[:, :, :, 4 + i]

    def e(a):
        return a[:, :, None]

    def calc_dp(line):
        return torch.where(
            hor_ctb,
            torch.abs(s(line, -2) - 2 * s(line, -2) + s(line, -1)),
            torch.abs(s(line, -3) - 2 * s(line, -2) + s(line, -1)))

    def calc_dq(line):
        return torch.abs(s(line, 0) - 2 * s(line, 1) + s(line, 2))

    def use_strong(line, d):
        m4, m3, m7 = s(line, 0), s(line, -1), s(line, 3)
        sp3 = torch.where(hor_ctb, torch.abs(s(line, -2) - m3), torch.abs(s(line, -4) - m3))
        sq3 = torch.abs(m7 - m4)
        return ((sp3 + sq3) < (beta >> 3)) & (d < (beta >> 2)) \
            & (torch.abs(m3 - m4) < ((tc * 5 + 1) >> 1))

    d0 = calc_dp(0) + calc_dq(0)
    d3 = calc_dp(dec_line) + calc_dq(dec_line)
    d = d0 + d3
    lg_act = large & (d < beta)
    sw = lg_act & use_strong(0, 2 * d0) & use_strong(dec_line, 2 * d3)

    m0v, m1v, m2v, m3v = sv(-4), sv(-3), sv(-2), sv(-1)
    m4v, m5v, m6v, m7v = sv(0), sv(1), sv(2), sv(3)
    tcv = e(tc)
    hcb = e(hor_ctb)

    sp2 = clip3(m1v - tcv, m1v + tcv, (3 * m0v + 2 * m1v + m2v + m3v + m4v + 4) >> 3)
    sp1 = clip3(m2v - tcv, m2v + tcv,
                (2 * m0v + m1v + 2 * m2v + m3v + m4v + m5v + 4) >> 3)
    sp0 = torch.where(
        hcb,
        clip3(m3v - tcv, m3v + tcv, (3 * m2v + 2 * m3v + m4v + m5v + m6v + 4) >> 3),
        clip3(m3v - tcv, m3v + tcv, (m0v + m1v + m2v + 2 * m3v + m4v + m5v + m6v + 4) >> 3))
    sq0 = torch.where(
        hcb,
        clip3(m4v - tcv, m4v + tcv, (2 * m2v + m3v + 2 * m4v + m5v + m6v + m7v + 4) >> 3),
        clip3(m4v - tcv, m4v + tcv, (m1v + m2v + m3v + 2 * m4v + m5v + m6v + m7v + 4) >> 3))
    sq1 = clip3(m5v - tcv, m5v + tcv, (m2v + m3v + m4v + 2 * m5v + m6v + 2 * m7v + 4) >> 3)
    sq2 = clip3(m6v - tcv, m6v + tcv, (m3v + m4v + m5v + 2 * m6v + 3 * m7v + 4) >> 3)
    dclip = clip3(-tcv, tcv, (((m4v - m3v) * 4) + m2v - m5v + 4) >> 3)
    wp0 = clip3(0, maxv, m3v + dclip)
    wq0 = clip3(0, maxv, m4v - dclip)

    act = e(active)
    sw_m = act & e(sw)
    wk_m = act & e(~sw)
    pm = ~e(no_p)
    qm = ~e(no_q)

    out = Wn.clone()

    def put(col, mask, val):
        out[:, :, :, col] = torch.where(mask, val, out[:, :, :, col])

    put(3, sw_m & pm, sp0)
    put(2, sw_m & pm & ~hcb, sp1)
    put(1, sw_m & pm & ~hcb, sp2)
    put(4, sw_m & qm, sq0)
    put(5, sw_m & qm, sq1)
    put(6, sw_m & qm, sq2)
    put(3, wk_m & pm, wp0)
    put(4, wk_m & qm, wq0)

    # overlap-sum: 8-wide windows 4 apart, row groups never overlap
    delta_w = out - Wn
    acc = torch.zeros((Hs, Ws + 2, loop_len, 4), dtype=torch.int32, device=dev)
    for dd in range(2):
        acc[:, dd:dd + Ws] += delta_w[:, :, :, 4 * dd:4 * dd + 4]
    acc = acc.permute(0, 2, 1, 3).reshape(Hs * loop_len, Wc + 8)
    out_plane = plane.clone()
    out_plane[:Hs * loop_len] += acc[:, 4:-4]
    return out_plane


def _chroma_geometry(hor: bool, sx: int, sy: int):
    """(loop_len, dec_line, map column step) of the oriented chroma plane."""
    if hor:
        return 4 >> sx, (1 if sx else 3), 1 << sy
    return 4 >> sy, (1 if sy else 3), 1 << sx


def deblock_dir_plain(y, cb, cr, *maps, bit_depth: int, hor: bool,
                      has_l: bool, has_cb: bool, has_cr: bool, sx: int, sy: int):
    """The jax deblock_dir in torch ops, on any device."""
    (l_act, l_tc, l_beta, l_mp, l_mq, l_nop, l_noq,
     cb_act, cb_tc, cb_beta, cr_act, cr_tc, cr_beta,
     c_large, c_nop, c_noq, c_hctb) = maps
    loop_len, dec_line, step = _chroma_geometry(hor, sx, sy)
    if hor:
        y, cb, cr = y.T, cb.T, cr.T
        maps = tuple(m.T for m in maps)
    l_maps = maps[0:7]
    c_cb = tuple(m[:, ::step] for m in maps[7:10])
    c_cr = tuple(m[:, ::step] for m in maps[10:13])
    c_sh = tuple(m[:, ::step] for m in maps[13:17])
    if has_l:
        pad = edge_pad(y, 0, 8)
        y = y + luma_ver_delta_plain(pad, *l_maps, bit_depth)[:, 8:-8]
    if has_cb:
        cb = chroma_ver_core(cb, *c_cb, *c_sh, bit_depth, loop_len, dec_line)
    if has_cr:
        cr = chroma_ver_core(cr, *c_cr, *c_sh, bit_depth, loop_len, dec_line)
    if hor:
        y, cb, cr = y.T, cb.T, cr.T
    return y.contiguous(), cb.contiguous(), cr.contiguous()


def _luma_cuda(y, maps, bit_depth, hor):
    dev = y.device
    KN.check(y, "y", torch.int32, dev)
    yv = y.T if hor else y
    mv = maps[0].T if hor else maps[0]
    out = torch.empty_like(y)
    KN.launch("vtm_deblock_luma_ver", dev,
              y.data_ptr(), out.data_ptr(), yv.shape[0], yv.shape[1],
              *yv.stride(), *(m.data_ptr() for m in maps), *mv.stride(),
              bit_depth)
    return out


def _chroma_cuda(planes, comp_maps, shared_maps, bit_depth, hor, sx, sy):
    loop_len, dec_line, step = _chroma_geometry(hor, sx, sy)
    mv = (comp_maps[0][0].T if hor else comp_maps[0][0])[:, ::step]
    return _chroma_seg_cuda(planes, comp_maps, shared_maps, mv, bit_depth, hor,
                            loop_len, dec_line)


def _chroma_seg_cuda(planes, comp_maps, shared_maps, mv, bit_depth, hor,
                     loop_len, dec_line):
    """Chroma edges of one or two planes of one shape (Cb and Cr: one
    launch), each with its (act, tc, beta) of `comp_maps`, the maps read
    through `mv`'s view (the segment grid: picture orientation of the
    planes, strided as given)."""
    dev = planes[0].device
    for p in planes:
        KN.check(p, "chroma plane", torch.int32, dev, planes[0].shape)
    pv = planes[0].T if hor else planes[0]
    Hc, Wc = pv.shape
    Hs, Ws = Hc // loop_len, Wc // 4
    if tuple(mv.shape) != (Hs, Ws):
        raise ValueError(f"chroma maps give a {tuple(mv.shape)} segment grid, "
                         f"the plane needs {(Hs, Ws)}")
    outs = [torch.empty_like(p) for p in planes]
    io = [(p.data_ptr(), o.data_ptr()) for p, o in zip(planes, outs)]
    comp = [tuple(m.data_ptr() for m in cm) for cm in comp_maps]
    if len(planes) == 1:
        io.append((None, None))
        comp.append((None, None, None))
    KN.launch("vtm_deblock_chroma_ver", dev, *io[0], *io[1], Hc, Wc,
              *pv.stride(), *comp[0], *comp[1],
              *(m.data_ptr() for m in shared_maps), *mv.stride(),
              Hs, Ws, loop_len, dec_line, bit_depth)
    return outs


CONFIG_FIELDS = ("threads", "smem_bytes", "registers", "blocks_per_sm", "local_bytes")
TILE_KERNELS = ("luma_tile_kernel<false>", "luma_tile_kernel<true>",
                "chroma_tile_kernel<false>", "chroma_tile_kernel<true>")


def kernel_config() -> dict:
    """The launch shape of the four tile kernels of csrc/deblock.cu (VER and
    HOR, luma and chroma) on the current card: {kernel: {CONFIG_FIELDS}}
    (registers and static shared bytes from cudaFuncGetAttributes, resident
    blocks from cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    n = len(CONFIG_FIELDS)
    buf = (ctypes.c_int * (n * len(TILE_KERNELS)))()
    err = KN.library().vtm_deblock_config(ctypes.cast(buf, ctypes.c_void_p))
    if err:
        raise RuntimeError(f"vtm_deblock_config: CUDA error {err}")
    return {k: dict(zip(CONFIG_FIELDS, buf[i * n:(i + 1) * n]))
            for i, k in enumerate(TILE_KERNELS)}


def luma_ver_delta_cuda(pad, active, tc, beta, max_p, max_q, no_p, no_q,
                        bit_depth: int):
    dev = pad.device
    KN.check(pad, "pad", torch.int32, dev)
    H, Wp = pad.shape
    maps = (active, tc, beta, max_p, max_q, no_p, no_q)
    for i, m in enumerate(maps):
        KN.check(m, f"luma map {i}", torch.bool if i in (0, 5, 6) else torch.int32,
                 dev, (H // 4, (Wp - 16) // 4))
    delta = torch.empty_like(pad)
    KN.launch("vtm_deblock_luma_ver_delta", dev, pad.data_ptr(), delta.data_ptr(),
              H, Wp, *(m.data_ptr() for m in maps), bit_depth)
    return delta


def luma_ver_delta(pad, active, tc, beta, max_p, max_q, no_p, no_q,
                   bit_depth: int):
    """Deltas [H, W + 16] of the vertical luma edges of `pad` [H, W + 16]
    (maps [H / 4, W / 4]): the CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor."""
    fn = pick(pad, luma_ver_delta_cuda, luma_ver_delta_plain)
    return fn(pad, active, tc, beta, max_p, max_q, no_p, no_q, bit_depth)


def deblock_dir_cuda(y, cb, cr, *maps, bit_depth: int, hor: bool,
                     has_l: bool, has_cb: bool, has_cr: bool, sx: int, sy: int):
    """deblock_dir through csrc/deblock.cu (out of place)."""
    dev = y.device
    H, W = y.shape
    for i, m in enumerate(maps):
        is_bool = i in (0, 5, 6, 7, 10, 13, 14, 15, 16)
        KN.check(m, f"deblock map {i}", torch.bool if is_bool else torch.int32,
                 dev, (H // 4, W // 4))
    if has_l:
        y = _luma_cuda(y, maps[0:7], bit_depth, hor)
    on = [(p, m) for p, m, o in ((cb, maps[7:10], has_cb), (cr, maps[10:13], has_cr))
          if o]
    if on:
        outs = iter(_chroma_cuda([p for p, _ in on], [m for _, m in on],
                                 maps[13:17], bit_depth, hor, sx, sy))
        cb = next(outs) if has_cb else cb
        cr = next(outs) if has_cr else cr
    return y, cb, cr


def deblock_dir(y, cb, cr, *maps, bit_depth: int, hor: bool, has_l: bool,
                has_cb: bool, has_cr: bool, sx: int, sy: int):
    """One-direction deblock of Y/Cb/Cr: the CUDA kernels for CUDA tensors,
    the plain version for CPU tensors."""
    if len(maps) != N_MAPS:
        raise ValueError(f"deblock_dir takes {N_MAPS} maps, got {len(maps)}")
    fn = deblock_dir_cuda if y.is_cuda else deblock_dir_plain
    return fn(y, cb, cr, *maps, bit_depth=bit_depth, hor=hor, has_l=has_l,
              has_cb=has_cb, has_cr=has_cr, sx=sx, sy=sy)


def deblock_luma_ver(plane, active, tc, beta, max_p, max_q, no_p, no_q,
                     bit_depth: int):
    """All vertical luma edges of `plane` (maps on its 4x4 grid): the
    reference's single-component wrapper (deblock_kernel.py:50), a
    composition of the port's luma filter.  CUDA tensors: the luma kernel of
    csrc/deblock.cu; CPU tensors: pad and `luma_ver_delta_plain`."""
    maps = (active, tc, beta, max_p, max_q, no_p, no_q)
    H, W = plane.shape
    for i, m in enumerate(maps):
        is_bool = i in (0, 5, 6)
        KN.check(m, f"luma map {i}", torch.bool if is_bool else torch.int32,
                 plane.device, (H // 4, W // 4))
    if pick(plane, True, False):
        return _luma_cuda(plane, maps, bit_depth, False)
    return plane + luma_ver_delta_plain(edge_pad(plane, 0, 8), *maps,
                                        bit_depth)[:, 8:-8]


def deblock_chroma_ver(plane, active, tc, beta, large, no_p, no_q, hor_ctb,
                       bit_depth: int, loop_len: int, dec_line: int):
    """Vertical chroma edges of `plane` with maps on its segment grid
    [Hc / loop_len, Wc / 4]: the reference's single-component wrapper
    (deblock_kernel.py:336).  CUDA tensors: the chroma kernel of
    csrc/deblock.cu; CPU tensors: `chroma_ver_core`."""
    maps = (active, tc, beta, large, no_p, no_q, hor_ctb)
    Hc, Wc = plane.shape
    for i, m in enumerate(maps):
        KN.check(m, f"chroma map {i}", torch.int32 if i in (1, 2) else torch.bool,
                 plane.device, (Hc // loop_len, Wc // 4))
    if pick(plane, True, False):
        return _chroma_seg_cuda([plane], [(active, tc, beta)],
                                (large, no_p, no_q, hor_ctb), active, bit_depth,
                                False, loop_len, dec_line)[0]
    return chroma_ver_core(plane, active, tc, beta, large, no_p, no_q, hor_ctb,
                           bit_depth, loop_len, dec_line)
