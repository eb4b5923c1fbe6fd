"""DMVR bilateral search, private-buffer FIR and BDOF blend: plain torch
versions and CUDA wrappers.

Counterpart of vtm_tpu/ops/refine_kernel.py (InterPrediction.cpp
xProcessDMVR / xBIPMVRefine / xDMVRCost / xSubPelErrorSrfc /
applyBiOptFlow), batched over 16x16-class sub-PUs.

* CPU tensors: `*_plain`.
* CUDA tensors: csrc/refine.cu: `vtm_dmvr_search` (a thread block of 96
  threads a 16-wide sub-PU, of 128 two 8-wide ones; the SAD and the
  minimum in one warp), `vtm_fir_blocks` (up to MAX_GROUPS groups of jobs
  a launch, a thread block a run of a group's jobs, a thread a job's
  column; one launch for all of `dmvr_final_pack`) and `vtm_bdof_blend`
  (a thread a row of one 4x4, 64-thread blocks).
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from vtm_tpu_torch.common import rom
from vtm_tpu_torch import kernels as KN
from vtm_tpu_torch.ops import clamp_index, host_to_device, mul32, pick, shl32

_BILINEAR = np.asarray(rom.get("bilinearFilterPrec4"), dtype=np.int32)  # (16, 2)
IF_INTERNAL_PREC = 14
IF_OFFS = 1 << (IF_INTERNAL_PREC - 1)
CENTRE = 12  # index of offset (0, 0) in the raster order of the search
# xBIPMVRefine search offsets (dx, dy) in evaluation order (raster in [-2, 2])
_OFFS = [(dx, dy) for dy in range(-2, 3) for dx in range(-2, 3)]
MAX_GROUPS = 6  # job groups a vtm_fir_blocks launch (csrc/refine.cu FIR_MAX_GROUPS)


@lru_cache(maxsize=None)
def _bilinear_table(device: torch.device) -> torch.Tensor:
    return host_to_device(torch.from_numpy(_BILINEAR), device)


def _bilinear_batch(pre, fx, fy, w: int, h: int, bd: int):
    """2-tap bilinear search-grid generation (xinitMC), batched.

    pre: int32 [N, h+3, w+3] prefetch windows (grid origin at (1, 1));
    fx, fy: int32 [N] fractional phases.  Returns [N, h, w] 10-bit grids."""
    c = _bilinear_table(pre.device)
    fxi, fyi = clamp_index(fx, 16), clamp_index(fy, 16)
    cx0 = c[fxi, 0][:, None, None]
    cx1 = c[fxi, 1][:, None, None]
    cy0 = c[fyi, 0][:, None, None]
    cy1 = c[fyi, 1][:, None, None]
    src = pre[:, 1:1 + h + 1, 1:1 + w + 1]
    s = 4 - (10 - bd)
    off = 1 << (s - 1)
    both0 = src[:, :h, :w] << (10 - bd)
    hx = (cx0 * src[:, :h, :w] + cx1 * src[:, :h, 1:w + 1] + off) >> s
    vy = (cy0 * src[:, :h, :w] + cy1 * src[:, 1:h + 1, :w] + off) >> s
    tmp = (cx0 * src[:, :, :w] + cx1 * src[:, :, 1:w + 1] + off) >> s
    hv = (cy0 * tmp[:, :h, :] + cy1 * tmp[:, 1:h + 1, :] + 8) >> 4
    fx0 = (fx == 0)[:, None, None]
    fy0 = (fy == 0)[:, None, None]
    return torch.where(fx0 & fy0, both0,
                       torch.where(fy0, hx, torch.where(fx0, vy, hv)))


def _div_for_maxq7(num, den):
    """xDivForMaxq7, vectorised (the caller keeps only den > 0 lanes)."""
    sign = num < 0
    n = num.abs()
    d = shl32(den, 3)
    ge = n >= d
    n = torch.where(ge, n - d, n)
    q = ge.to(torch.int32) << 1
    d = d >> 1
    ge = n >= d
    n = torch.where(ge, n - d, n)
    q = (q + ge.to(torch.int32)) << 1
    q = q + (n >= (d >> 1)).to(torch.int32)
    return torch.where(sign, -q, q)


def dmvr_search_plain(pre0, pre1, f0x, f0y, f1x, f1y, bd: int, dx: int, dy: int):
    """xBIPMVRefine + xDMVRSubPixelErrorSurface, batched over sub-PUs.

    pre0/pre1: int32 [N, dy+7, dx+7] luma prefetch windows; f*: int32 [N]
    fractional phases of the merge MVs.  Returns int32 [3, N]: the refined
    MVD (x, y) in 1/16 sample and the minimum cost."""
    g0 = _bilinear_batch(pre0, f0x, f0y, dx + 4, dy + 4, bd)
    g1 = _bilinear_batch(pre1, f1x, f1y, dx + 4, dy + 4, bd)
    costs = []
    for dmx, dmy in _OFFS:
        a = g0[:, 2 + dmy:2 + dmy + dy:2, 2 + dmx:2 + dmx + dx]
        b = g1[:, 2 - dmy:2 - dmy + dy:2, 2 - dmx:2 - dmx + dx]
        costs.append((a - b).abs().sum(dim=(1, 2), dtype=torch.int32))
    cvec = torch.stack(costs, dim=1)  # [N, 25]

    c00 = cvec[:, CENTRE]
    minc0 = c00 - (c00 >> 2)
    early = minc0 < dx * dy
    cvec[:, CENTRE] = minc0
    # xBIPMVRefine seeds minCost with the biased centre and takes strict <,
    # so the centre wins any tie with the minimum; otherwise the first
    # minimum in evaluation order (torch.argmin returns the first)
    min_cost = cvec.min(dim=1).values
    best = cvec.argmin(dim=1).to(torch.int32)
    best = torch.where(minc0 == min_cost, CENTRE, best)
    zero = torch.zeros_like(best)
    bx = torch.where(early, zero, best % 5 - 2)
    by = torch.where(early, zero, best // 5 - 2)
    min_cost = torch.where(early, minc0, min_cost)

    total_x = bx << 4
    total_y = by << 4
    do_sub = ~early & (bx.abs() != 2) & (by.abs() != 2)

    def nb(dy_, dx_):
        idx = clamp_index((by + 2 + dy_) * 5 + (bx + 2 + dx_), 25)
        return cvec.gather(1, idx[:, None])[:, 0]

    sC, sL, sT, sR, sB = min_cost, nb(0, -1), nb(-1, 0), nb(0, 1), nb(1, 0)

    def axis_delta(sa, sb):
        num = (sa - sb) << 4
        den = sa + sb - (sC << 1)
        d_div = _div_for_maxq7(num, den)
        d_edge = torch.where(sa == sC, -8, 8).to(torch.int32)
        d = torch.where((sa != sC) & (sb != sC), d_div, d_edge)
        return torch.where(den != 0, d, zero)

    total_x = total_x + torch.where(do_sub, axis_delta(sL, sR), zero)
    total_y = total_y + torch.where(do_sub, axis_delta(sT, sB), zero)
    return torch.stack([total_x, total_y, min_cost])


def dmvr_search_cuda(pre0, pre1, f0x, f0y, f1x, f1y, bd: int, dx: int, dy: int):
    dev = pre0.device
    N = pre0.shape[0]
    if (dx, dy) not in ((8, 8), (8, 16), (16, 8), (16, 16)):
        raise ValueError(f"dmvr_search: sub-PU {dx}x{dy} not supported")
    KN.check(pre0, "pre0", torch.int32, dev, (N, dy + 7, dx + 7))
    KN.check(pre1, "pre1", torch.int32, dev, (N, dy + 7, dx + 7))
    for name, f in (("f0x", f0x), ("f0y", f0y), ("f1x", f1x), ("f1y", f1y)):
        KN.check(f, name, torch.int32, dev, (N,))
    out = torch.empty((3, N), dtype=torch.int32, device=dev)
    if N:
        KN.launch("vtm_dmvr_search", dev, pre0.data_ptr(), pre1.data_ptr(),
                  f0x.data_ptr(), f0y.data_ptr(), f1x.data_ptr(), f1y.data_ptr(),
                  _bilinear_table(dev).data_ptr(), N, dx, dy, bd,
                  out.data_ptr())
    return out


def dmvr_search(pre0, pre1, f0x, f0y, f1x, f1y, bd: int, dx: int, dy: int):
    """DMVR search: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors."""
    fn = pick(pre0, dmvr_search_cuda, dmvr_search_plain)
    return fn(pre0, pre1, f0x, f0y, f1x, f1y, bd=bd, dx=dx, dy=dy)


def fir_blocks_plain(bufs, x0, y0, cfh, cfv, w: int, h: int, taps: int, bd: int):
    """Batched two-pass FIR over per-block private support buffers, giving
    the 14-bit intermediate (the rnd=False / notLast path of
    InterpolationFilter::filter).  Reads clamp at the buffer's edges, which
    equals the reference's edge-padded DMVR prefetch buffers
    (xFinalPaddedMCForDMVR): replication is idempotent under clamping.

    bufs: int32 [N, H, W]; x0, y0: int32 [N] block origin inside the buffer;
    cfh, cfv: int32 [N, taps] (identity row for phase 0).
    Returns int32 [N, h, w]."""
    N, H, W = bufs.shape
    half = taps // 2 - 1
    hr = max(2, IF_INTERNAL_PREC - bd)
    s1 = 6 - hr
    off1 = -(IF_OFFS << s1)
    dev = bufs.device
    iy = clamp_index(y0[:, None] - half
                     + torch.arange(h + taps - 1, dtype=torch.int32, device=dev), H)
    ix = clamp_index(x0[:, None] - half
                     + torch.arange(w + taps - 1, dtype=torch.int32, device=dev), W)
    win = bufs[torch.arange(N, device=dev)[:, None, None], iy[:, :, None],
               ix[:, None, :]]
    tmp = torch.zeros((N, h + taps - 1, w), dtype=torch.int32, device=dev)
    for k in range(taps):
        tmp = tmp + cfh[:, k, None, None] * win[:, :, k:k + w]
    tmp = (tmp + off1) >> s1
    acc = torch.zeros((N, h, w), dtype=torch.int32, device=dev)
    for k in range(taps):
        acc = acc + cfv[:, k, None, None] * tmp[:, k:k + h, :]
    return acc >> 6


def fir_groups_cuda(groups, bd: int, out: torch.Tensor) -> torch.Tensor:
    """csrc/refine.cu `vtm_fir_blocks` on up to MAX_GROUPS groups in one
    launch.  groups: ((bufs, x0, y0, cfh, cfv), w, h, taps, offset) each,
    its [N, h, w] outputs written to the flat int32 `out` from `offset`."""
    if not 1 <= len(groups) <= MAX_GROUPS:
        raise ValueError(f"fir_blocks: {len(groups)} groups, at most {MAX_GROUPS} a launch")
    dev = out.device
    KN.check(out, "out", torch.int32, dev)
    ptrs, dims, total = [], [], 0
    for (bufs, x0, y0, cfh, cfv), w, h, taps, offset in groups:
        N, H, W = bufs.shape
        KN.check(bufs, "bufs", torch.int32, dev)
        KN.check(x0, "x0", torch.int32, dev, (N,))
        KN.check(y0, "y0", torch.int32, dev, (N,))
        KN.check(cfh, "cfh", torch.int32, dev, (N, taps))
        KN.check(cfv, "cfv", torch.int32, dev, (N, taps))
        if not 0 <= offset <= out.numel() - N * h * w:
            raise ValueError(f"fir_blocks: outputs at {offset} leave `out` ({out.numel()})")
        ptrs += [a.data_ptr() for a in (bufs, x0, y0, cfh, cfv)]
        dims += [N, H, W, w, h, taps, offset]
        total += N * h * w
    if total:
        p = (ctypes.c_void_p * len(ptrs))(*ptrs)
        d = (ctypes.c_int * len(dims))(*dims)
        KN.launch("vtm_fir_blocks", dev, len(groups), ctypes.addressof(p),
                  ctypes.addressof(d), bd, out.data_ptr())
    return out


def fir_blocks_cuda(bufs, x0, y0, cfh, cfv, w: int, h: int, taps: int, bd: int,
                    out: torch.Tensor | None = None):
    """csrc/refine.cu `vtm_fir_blocks`, one group; writes into `out` when
    given."""
    N = bufs.shape[0]
    if out is None:
        out = torch.empty((N, h, w), dtype=torch.int32, device=bufs.device)
    KN.check(out, "out", torch.int32, bufs.device, (N, h, w))
    fir_groups_cuda([((bufs, x0, y0, cfh, cfv), w, h, taps, 0)], bd, out.view(-1))
    return out


def fir_blocks(bufs, x0, y0, cfh, cfv, w: int, h: int, taps: int, bd: int):
    """Private-buffer FIR: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    fn = pick(bufs, fir_blocks_cuda, fir_blocks_plain)
    return fn(bufs, x0, y0, cfh, cfv, w=w, h=h, taps=taps, bd=bd)


def dmvr_final_pack(l0, l1, cargs, w: int, h: int, wc: int, hc: int,
                    bd: int) -> torch.Tensor:
    """Both lists' final luma FIR and all chroma FIRs into one flat int32
    output (one device-to-host copy); on the card, one launch.

    l0/l1: (bufs, x0, y0, cfh, cfv) luma arguments; cargs: the chroma
    arguments, list-major ([l0 comps..., l1 comps...])."""
    jobs = [(a, w, h, 8) for a in (l0, l1)] + [(a, wc, hc, 4) for a in cargs]
    bufs = l0[0]
    sizes = [a[0].shape[0] * hh * ww for a, ww, hh, _ in jobs]
    flat = torch.empty(sum(sizes), dtype=torch.int32, device=bufs.device)
    offsets = [sum(sizes[:i]) for i in range(len(sizes))]
    if pick(bufs, True, False):
        return fir_groups_cuda([j + (o,) for j, o in zip(jobs, offsets)], bd, flat)
    for (a, ww, hh, taps), pos, size in zip(jobs, offsets, sizes):
        flat[pos:pos + size] = fir_blocks_plain(*a, w=ww, h=hh, taps=taps,
                                                bd=bd).view(-1)
    return flat


def _floor_log2(x):
    """floor(log2(max(x, 1))) by comparisons, saturating at 19 as the
    reference's does."""
    lg = torch.zeros_like(x)
    for i in range(1, 20):
        lg = lg + (x >= (1 << i)).to(x.dtype)
    return lg


def _replicate_ring(a):
    """[N, h, w] -> [N, h+2, w+2], edges replicated."""
    a = torch.cat([a[:, :, :1], a, a[:, :, -1:]], dim=2)
    return torch.cat([a[:, :1, :], a, a[:, -1:, :]], dim=1)


def bdof_blend_batch_plain(p0e, p1e, bd: int, w: int, h: int):
    """applyBiOptFlow core, batched: p0e/p1e int32 [N, h+2, w+2] extended
    predictions (centre = 14-bit MC, ring = shifted integer samples).
    Returns int32 [N, h, w] final samples."""
    shift1 = 6

    def grads(pe):
        gx = (pe[:, 1:h + 1, 2:w + 2] >> shift1) - (pe[:, 1:h + 1, 0:w] >> shift1)
        gy = (pe[:, 2:h + 2, 1:w + 1] >> shift1) - (pe[:, 0:h, 1:w + 1] >> shift1)
        return _replicate_ring(gx), _replicate_ring(gy)

    gx0, gy0 = grads(p0e)
    gx1, gy1 = grads(p1e)
    p0r = _replicate_ring(p0e[:, 1:h + 1, 1:w + 1])
    p1r = _replicate_ring(p1e[:, 1:h + 1, 1:w + 1])

    shift_num = IF_INTERNAL_PREC + 1 - bd
    offset = (1 << (shift_num - 1)) + 2 * IF_OFFS
    limit = 15
    maxv = (1 << bd) - 1

    tmp_gx = (gx0 + gx1) >> 1
    tmp_gy = (gy0 + gy1) >> 1
    tmp_di = (p1r >> 4) - (p0r >> 4)
    sgx = torch.sign(tmp_gx)
    sgy = torch.sign(tmp_gy)
    nby, nbx = h // 4, w // 4

    def wsum(a):
        s = torch.zeros((a.shape[0], nby, nbx), dtype=torch.int32, device=a.device)
        for i in range(6):
            for j in range(6):
                s = s + a[:, i:i + 4 * nby:4, j:j + 4 * nbx:4]
        return s

    sum_abs_gx = wsum(tmp_gx.abs())
    sum_abs_gy = wsum(tmp_gy.abs())
    sum_dix = wsum(mul32(sgx, tmp_di))
    sum_diy = wsum(mul32(sgy, tmp_di))
    sum_sign = wsum(mul32(sgy, tmp_gx))

    lg_gx = _floor_log2(sum_abs_gx.clamp(min=1))
    lg_gy = _floor_log2(sum_abs_gy.clamp(min=1))
    zero = torch.zeros_like(sum_dix)
    tmpx = torch.where(sum_abs_gx == 0, zero, shl32(sum_dix, 2) >> lg_gx)
    tmpx = tmpx.clamp(-limit, limit)
    mains = sum_sign >> 12
    secs = sum_sign & 4095
    tmp_data = (shl32(mul32(tmpx, mains), 12) + mul32(tmpx, secs)) >> 1
    tmpy = torch.where(sum_abs_gy == 0, zero, (shl32(sum_diy, 2) - tmp_data) >> lg_gy)
    tmpy = tmpy.clamp(-limit, limit)

    tx = tmpx.repeat_interleave(4, dim=1).repeat_interleave(4, dim=2)
    ty = tmpy.repeat_interleave(4, dim=1).repeat_interleave(4, dim=2)
    inner = (slice(None), slice(1, h + 1), slice(1, w + 1))
    b = mul32(tx, gx0[inner] - gx1[inner]) + mul32(ty, gy0[inner] - gy1[inner])
    val = (p0r[inner] + p1r[inner] + b + offset) >> shift_num
    return val.clamp(0, maxv)


def bdof_blend_batch_cuda(p0e, p1e, bd: int, w: int, h: int):
    dev = p0e.device
    N = p0e.shape[0]
    if w not in (8, 16) or h not in (8, 16):
        raise ValueError(f"bdof_blend_batch: block {w}x{h} not supported")
    KN.check(p0e, "p0e", torch.int32, dev, (N, h + 2, w + 2))
    KN.check(p1e, "p1e", torch.int32, dev, (N, h + 2, w + 2))
    out = torch.empty((N, h, w), dtype=torch.int32, device=dev)
    if N:
        KN.launch("vtm_bdof_blend", dev, p0e.data_ptr(), p1e.data_ptr(), N,
                  w, h, bd, out.data_ptr())
    return out


def bdof_blend_batch(p0e, p1e, bd: int, w: int, h: int):
    """BDOF blend: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors."""
    fn = pick(p0e, bdof_blend_batch_cuda, bdof_blend_batch_plain)
    return fn(p0e, p1e, bd=bd, w=w, h=h)
