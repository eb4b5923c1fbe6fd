"""Whole-frame batched intra RMD (rough mode decision) on a torch device.

Counterpart of vtm_tpu/encoder/rmd_tpu.py.  Every candidate block of a
frame (each (w, h) size class of the intra partition universe at every
legal offset) is costed for all 67 regular modes and, with MIP, every MIP
mode and transpose: references come from the edge-padded SOURCE plane,
predictions are compared with the source by the mean-scaled Hadamard SATD.
The host then ranks candidates from the table.

Per class, `class_costs` returns the reference class function's `(out,
red)`: out (P, 67 + 2 n_mip) int32 in the native column order [0, 1, 18,
50, ver modes..., hor modes..., (mip0, F), (mip0, T), ...] and red (P, 5) =
(min and first argmin over the 67 native columns, planar, min and first
argmin over the MIP columns, or 2^30 and 0 without MIP).

* CPU tensors: `class_costs_plain`, the jax function's gather formulation
  in torch int32 (the fp32 matrix form of the reference served the TPU's
  matrix unit only), in chunks of positions.
* CUDA tensors: csrc/rmd.cu, three kernels (angular, MIP, reduce), one
  instantiation per class, with the warp SATD of csrc/satd.cuh fused in; no
  prediction is ever stored.

The per-class tables come from the numpy table functions below
(`class_tables`, `rom.mip_matrix`), indexing the reference buffer C = [Tu |
Lu | Tf | Lf | 0], and are uploaded once per class and device in two forms:
per-sample gather indices for the plain version, and the compact table of
`_compact_tables` (a reference line per mode, a tap row and a base per
(mode, row), PDPC weights per (mode, column)) that the kernel stages in
shared memory.

Not carried over: the power-of-two position buckets (they bounded XLA
compiles), the fp32 matmul tables, `_device_consts`, the thread-pool
dispatch, `accel_device` and VTM_TPU_RMD_DEVICE: the caller names the
device.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from vtm_tpu_torch import kernels as KN
from vtm_tpu_torch.common import rom
from vtm_tpu_torch.device import resolve_device
from vtm_tpu_torch.ops import clamp_index, pick, upload
from vtm_tpu_torch.ops import intra as I
from vtm_tpu_torch.ops.rdcost import satd_batch_plain

N_ANG = 67
PAD_R = 2 * 64 + 2  # right/bottom edge padding of the source plane
NO_MIP = 1 << 30  # red[:, 3] of a class without MIP
GROUPS = ("ver", "hor")
# the compact table's layout, as csrc/rmd.cu reads it (the constants there):
# (length, tap rows, offset of the tap rows, 0), then per group (M, first
# native column, offsets of sym, rows, pdpc, side, 0, 0)
TAB_HEAD = 4 + 8 * len(GROUPS)
PDPC_COLS = 16  # PDPC weights are kept for the first 16 columns of a mode
MAX_TAPS = 64
# sample-mode products of one plain chunk (int32 tensors of 32 MB)
CHUNK = 1 << 23
# what csrc/rmd.cu:vtm_rmd_config reports per kernel of a class
CONFIG_FIELDS = ("threads", "smem_bytes", "blocks_per_sm", "positions_per_block",
                 "registers", "local_bytes")


# ---------------------------------------------------------------------------
# host-side per-class mode tables (depend only on (w, h, bit_depth))

_CLASS_TABLES: dict = {}


def _seg_bases(w: int, h: int):
    """Index bases of the concat ref buffer C = [Tu|Lu|Tf|Lf|0]."""
    tu = 0
    lu = 2 * w + 1
    tf = lu + 2 * h + 1
    lf = tf + 2 * w + 1
    zero = lf + 2 * h + 1
    return tu, lu, tf, lf, zero


def _build_mode_tables(w: int, h: int, bit_depth: int):
    """Per-mode symbolic gather tables for angular modes 2..66.

    Returns dict with two groups ('ver'/'hor'), each holding stacked
    numpy arrays: modes, rm_sym (M,L), gi (M,dh,dw,4), f (M,dh,4),
    wl (M,dw), rs_sym (M,LS), sidx (M,dh,dw); plus scalars.
    """
    tu0, lu0, tf0, lf0, zslot = _seg_bases(w, h)
    lc = zslot + 1

    groups = {True: [], False: []}
    for m in range(2, 67):
        if m in (I.HOR_IDX, I.VER_IDX):
            continue  # angle==0: special PDPC, computed in _planar_dc_jnp
        p = I.IntraParams(m, w, h, w, h, True, 0, False, False)
        angle, inv_angle, is_ver = p.intra_pred_angle, p.inv_angle, p.is_mode_ver
        filt = p.ref_filter_flag
        # main/side segment bases in C for this orientation
        if is_ver:
            t_seg = tf0 if filt else tu0
            l_seg = lf0 if filt else lu0
            mw, mh = w, h  # main length w-based, side h-based
        else:
            t_seg = lf0 if filt else lu0  # "top" role played by left col
            l_seg = tf0 if filt else tu0
            mw, mh = h, w
        dh, dw = (h, w) if is_ver else (w, h)
        # ref_main symbolic array over absolute indices [0 .. rm + 2mw + 2]
        if angle < 0:
            rm = mh
            L = mh + mw + 2
            sym = np.full(L, zslot, dtype=np.int64)
            for k in range(mw + 2):
                sym[rm + k] = t_seg + k
            ks = np.arange(-mh, 0, dtype=np.int64)
            sidx = np.minimum((-ks * inv_angle + 256) >> 9, mh)
            sym[0:mh] = l_seg + sidx
            rs_len = 0  # no pos-angle PDPC
            rs_sym = np.zeros(1, dtype=np.int64)
        else:
            rm = 0
            L = 2 * mw + 3
            sym = np.full(L, zslot, dtype=np.int64)
            for k in range(2 * mw + 1):
                sym[k] = t_seg + k
            sym[2 * mw + 1 :] = t_seg + 2 * mw
            # side for PDPC: unpadded side col (same filter choice),
            # zeros beyond 2mh (scalar path zero-pads)
            rs_len = 2 * mh + 1
            rs_sym = np.full(rs_len, zslot, dtype=np.int64)
            for k in range(rs_len):
                rs_sym[k] = l_seg + k
        # per-row interpolation
        di = np.zeros(dh, dtype=np.int64)
        f = np.zeros((dh, 4), dtype=np.int64)
        yr = np.arange(dh, dtype=np.int64)
        delta_pos = angle * (1 + yr)
        delta_int = delta_pos >> 5
        delta_fract = delta_pos & 31
        if (abs(angle) & 0x1F) == 0:
            f[:] = np.array([64, 0, 0, 0], dtype=np.int64)
            di[:] = delta_int + 1
        elif not p.interpolation_flag:
            f[:] = I._CHROMA_FILTER[delta_fract]
            di[:] = delta_int
        else:
            hf = delta_fract >> 1
            f[:] = np.stack([16 - hf, 32 - hf, 16 + hf, hf], axis=1)
            di[:] = delta_int
        xr = np.arange(dw, dtype=np.int64)
        gi = rm + di[:, None] + xr[None, :]  # (dh, dw) base gather idx
        # PDPC (angle > 0 only; angle < 0 has apply_pdpc False; angle==0
        # excluded from this table — handled separately)
        wl = np.zeros(dw, dtype=np.int64)
        sidx_t = np.zeros((dh, dw), dtype=np.int64)
        # the side index as min(row + soff[column], side[1]) into the side
        # line from C index side[0] (the compact form of sidx)
        soff = np.zeros(dw, dtype=np.int64)
        side = (int(rs_sym[0]), 0)
        if angle > 0 and p.apply_pdpc:
            scale = p.angular_scale
            nx = min(3 << scale, dw)
            wl[:nx] = 32 >> ((2 * xr[:nx]) >> scale)
            inv_sum = 256 + (xr + 1) * inv_angle
            soff = (inv_sum >> 9) + 1
            s_t = yr[:, None] + soff[None, :]
            sidx_t[:] = np.minimum(s_t, rs_len - 1 if rs_len else 0)
            side = (l_seg, rs_len - 1)
        groups[is_ver].append(
            dict(mode=m, sym=sym, gi=gi, f=f, wl=wl, rs_sym=rs_sym,
                 sidx=sidx_t, soff=soff, side=side,
                 clip_free=(abs(angle) & 0x1F) == 0
                 and not (angle > 0 and p.apply_pdpc))
        )

    out = {}
    for is_ver, recs in groups.items():
        if not recs:
            continue
        M = len(recs)
        lmax = max(len(r["sym"]) for r in recs)
        lsmax = max(len(r["rs_sym"]) for r in recs)
        sym = np.full((M, lmax), zslot, dtype=np.int64)
        rs = np.full((M, lsmax), zslot, dtype=np.int64)
        dh, dw = (h, w) if is_ver else (w, h)
        gi = np.zeros((M, dh, dw), dtype=np.int64)
        f = np.zeros((M, dh, 4), dtype=np.int64)
        wl = np.zeros((M, dw), dtype=np.int64)
        sx = np.zeros((M, dh, dw), dtype=np.int64)
        modes = []
        for i, r in enumerate(recs):
            sym[i, : len(r["sym"])] = r["sym"]
            rs[i, : len(r["rs_sym"])] = r["rs_sym"]
            gi[i] = r["gi"]
            f[i] = r["f"]
            wl[i] = r["wl"]
            sx[i] = r["sidx"]
            modes.append(r["mode"])
        out["ver" if is_ver else "hor"] = dict(
            modes=modes, sym=sym, rs=rs, gi=gi, f=f, wl=wl, sidx=sx,
            soff=np.stack([r["soff"] for r in recs]),
            side=np.array([r["side"] for r in recs], dtype=np.int64),
        )
    out["lc"] = lc
    return out


def class_tables(w: int, h: int, bit_depth: int):
    key = (w, h, bit_depth)
    t = _CLASS_TABLES.get(key)
    if t is None:
        t = _build_mode_tables(w, h, bit_depth)
        _CLASS_TABLES[key] = t
    return t


def _class_strides(w: int, h: int):
    def stride(d):
        if d <= 8:
            return 4
        if d <= 16:
            return 8
        return d  # 32/64-wide blocks sit at their own alignment

    return stride(w), stride(h)


def intra_class_list(cfg) -> list[tuple[int, int]]:
    """Size classes reachable by the intra partitioner (QT to 8 + <=2 MTT
    levels, min CU 4, max BT/TT 32)."""
    classes = []
    for lw in range(2, cfg.log2_ctu_size + 1):
        for lh in range(2, cfg.log2_ctu_size + 1):
            w, hh = 1 << lw, 1 << lh
            if w == hh:
                classes.append((w, hh))
            else:
                if max(w, hh) <= (1 << cfg.log2_max_bt_intra) * 2 and \
                        cfg.max_mtt_depth_intra > 0:
                    # rects need at least one MTT split from a square
                    if max(w, hh) // min(w, hh) <= 8 and max(w, hh) <= 32:
                        classes.append((w, hh))
    return classes


@dataclass
class ClassConsts:
    """Device tables of one (w, h, bit depth, MIP) class.

    groups: per angular group, dict(modes, ver, dh, dw, cidx (M, dh, dw, 4)
      index into C of each filter tap, f (M, dh, 4) taps, wl (M, dw) PDPC
      weights, scidx (M, dh, dw) index into C of the PDPC side sample): the
      plain version's per-sample gather tables.
    tab: the compact table of csrc/rmd.cu (`_compact_tables`).
    wadj: MIP weights (n_mip, red * red, input_size) int32, or None."""

    w: int
    h: int
    bit_depth: int
    with_mip: bool
    groups: list
    mode_order: np.ndarray
    tab: torch.Tensor
    wadj: torch.Tensor | None
    n_mip: int
    ncols: int


_CONSTS: dict = {}


def _mip_weights(w: int, h: int) -> np.ndarray:
    """The reference's adjusted MIP weight tensor (rmd_tpu.py:_mip_jnp)."""
    size_id = I.mip_size_id(w, h)
    red = 4 if size_id < 2 else 8
    input_size = 4 if size_id == 0 else 8
    mat = rom.mip_matrix(size_id).astype(np.int64)
    n_modes = mat.shape[0]
    wadj = np.zeros((n_modes, red * red, input_size), dtype=np.int64)
    for mi in range(n_modes):
        wflat = mat[mi].ravel()
        wpos = 0
        for pos in range(red * red):
            if size_id == 2:
                wpos -= 1
            for i in range(0 if size_id != 2 else 1, input_size):
                wadj[mi, pos, i] = wflat[wpos + i]
            wpos += input_size
    return wadj


def sym_stride(dh: int, dw: int) -> int:
    """Entries of a mode's reference line in the compact table: enough for
    every tap a dh x dw block reads (csrc/rmd.cu:sym_stride)."""
    return max(dh + dw + 3, 2 * dw + 4)


def tab_cap(w: int, h: int) -> int:
    """The most ints a class's compact table may hold: the shared memory
    csrc/rmd.cu sets aside for it (tab_cap there)."""
    return TAB_HEAD + MAX_TAPS + (N_ANG - 4) * (
        max(sym_stride(h, w), sym_stride(w, h)) + max(w, h) + PDPC_COLS + 2)


def _compact_tables(tabs, w: int, h: int) -> np.ndarray:
    """The class's angular tables in the layout of csrc/rmd.cu.

    Per group (ver: the h x w block; hor: the transposed w x h block), per
    mode m: sym (sym_stride) the index into C of ref_m[j], the zero slot
    past the mode's line; rows (dh) rowbase | tap row << 16, so that the
    taps of sample (r, x) read ref_m[rowbase + x + k]; pdpc (PDPC_COLS)
    weight | side offset << 8; side (2) base and clamp, the side sample of
    (r, x) being C[base + min(r + offset, clamp)].  The tap rows (4 signed
    bytes each) are shared by both groups."""
    zslot = tabs["lc"] - 1
    gs = [tabs[g] for g in GROUPS]
    taps, tap_of = np.unique(np.concatenate([g["f"].reshape(-1, 4) for g in gs]),
                             axis=0, return_inverse=True)
    tap_of = tap_of.reshape(-1)
    if len(taps) > MAX_TAPS or taps.min() < -128 or taps.max() > 127:
        raise AssertionError(f"class {w}x{h}: taps do not pack")
    head = np.zeros(TAB_HEAD, np.int64)
    body = [(taps[:, 3] << 24) | ((taps[:, 2] & 0xFF) << 16)
            | ((taps[:, 1] & 0xFF) << 8) | (taps[:, 0] & 0xFF)]
    head[1:3] = len(taps), TAB_HEAD
    pos, col, t0 = TAB_HEAD + len(taps), 4, 0
    for gi, g in enumerate(gs):
        M, dh, dw = g["gi"].shape
        ls = sym_stride(dh, dw)
        rowbase = g["gi"][:, :, 0]
        if (g["gi"] != rowbase[..., None] + np.arange(dw)).any() \
                or rowbase.min() < 0 or g["gi"].max() + 4 > ls \
                or g["sym"].shape[1] > ls or g["wl"][:, PDPC_COLS:].any():
            raise AssertionError(f"class {w}x{h}: tables do not compact")
        sym = np.full((M, ls), zslot, np.int64)
        sym[:, :g["sym"].shape[1]] = g["sym"]
        rows = rowbase | (tap_of[t0:t0 + M * dh].reshape(M, dh) << 16)
        t0 += M * dh
        nc = min(dw, PDPC_COLS)
        pdpc = np.zeros((M, PDPC_COLS), np.int64)
        pdpc[:, :nc] = g["wl"][:, :nc] | (g["soff"][:, :nc] << 8)
        parts = (sym, rows, pdpc, g["side"])
        head[4 + 8 * gi:6 + 8 * gi] = M, col
        for k, a in enumerate(parts):
            head[6 + 8 * gi + k] = pos
            body.append(a.reshape(-1))
            pos += a.size
        col += M
    head[0] = pos
    if pos > tab_cap(w, h):
        raise AssertionError(f"class {w}x{h}: {pos} ints > {tab_cap(w, h)}")
    return np.concatenate([head] + body)


def _gather_tables(g, zslot: int, h: int, w: int, is_ver: bool) -> dict:
    """The plain version's per-sample tables of one group (the reference's
    gather form)."""
    sym, L = g["sym"], g["sym"].shape[1]
    M = len(g["modes"])
    j = g["gi"][..., None] + np.arange(4)  # (M, dh, dw, 4) index into sym
    # a tap past the end of the mode's reference row has weight 0 (the
    # reference's matrix form reads the zero slot there)
    cidx = np.where(j < L, sym[np.arange(M)[:, None, None, None],
                               np.minimum(j, L - 1)], zslot)
    scidx = g["rs"][np.arange(M)[:, None, None], g["sidx"]]
    return dict(modes=list(g["modes"]), ver=is_ver,
                dh=h if is_ver else w, dw=w if is_ver else h,
                cidx=cidx, f=g["f"], wl=g["wl"], scidx=scidx)


def class_consts(w: int, h: int, bit_depth: int, with_mip: bool,
                 device) -> ClassConsts:
    """The tables of one class on `device`, built once per process."""
    device = torch.device(device)
    key = (w, h, bit_depth, with_mip, device)
    c = _CONSTS.get(key)
    if c is not None:
        return c
    tabs = class_tables(w, h, bit_depth)
    if any(g not in tabs for g in GROUPS):
        raise AssertionError(f"class {w}x{h}: an angular group is empty")
    groups = [_gather_tables(tabs[g], tabs["lc"] - 1, h, w, g == "ver")
              for g in GROUPS]
    mode_order = [0, 1, 18, 50] + [m for g in groups for m in g["modes"]]
    if len(mode_order) != N_ANG:
        raise AssertionError(f"class {w}x{h}: {len(mode_order)} angular columns")
    names = ("cidx", "f", "wl", "scidx")
    arrays = [_compact_tables(tabs, w, h)] + [g[n] for g in groups for n in names]
    if with_mip:
        arrays.append(_mip_weights(w, h))
    dev = upload(arrays, device)
    for k, g in enumerate(groups):
        g.update(zip(names, dev[1 + 4 * k:5 + 4 * k]))
    n_mip = arrays[-1].shape[0] if with_mip else 0
    c = ClassConsts(w, h, bit_depth, with_mip, groups, np.array(mode_order),
                    dev[0], dev[-1] if with_mip else None, n_mip, N_ANG + 2 * n_mip)
    _CONSTS[key] = c
    return c


# ---------------------------------------------------------------------------
# plain version (torch counterparts of rmd_tpu.py's _jnp helpers)


def _i32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=torch.int32, device=device)


def _filter_refs(tu, lu, w: int, h: int):
    """rmd_tpu.py:_filter_refs_jnp (xFilterReferenceSamples)."""
    corner = (tu[:, 0] + tu[:, 1] + lu[:, 0] + lu[:, 1] + 2) >> 2
    ps, phs = 2 * w, 2 * h
    tf = torch.cat([corner[:, None],
                    (tu[:, 0:ps - 1] + 2 * tu[:, 1:ps] + tu[:, 2:ps + 1] + 2) >> 2,
                    tu[:, ps:ps + 1]], dim=1)
    lf = torch.cat([corner[:, None],
                    (lu[:, 0:phs - 1] + 2 * lu[:, 1:phs] + lu[:, 2:phs + 1] + 2) >> 2,
                    lu[:, phs:phs + 1]], dim=1)
    return tf, lf


def _pdpc_planar_dc(pred, top, left, w: int, h: int):
    """rmd_tpu.py:_pdpc_planar_dc_jnp."""
    dev = pred.device
    scale = (I.floor_log2(w) - 2 + I.floor_log2(h) - 2 + 2) >> 2
    y = np.arange(h)[:, None]
    x = np.arange(w)[None, :]
    wt = _i32(32 >> np.minimum(31, (y << 1) >> scale), dev)
    wlx = _i32(32 >> np.minimum(31, (x << 1) >> scale), dev)
    lcol = left[:, 1:h + 1][:, :, None]
    trow = top[:, 1:w + 1][:, None, :]
    return pred + ((wlx * (lcol - pred) + wt * (trow - pred) + 32) >> 6)


def _planar_dc(tu, lu, tf, lf, src, w: int, h: int, maxv: int):
    """rmd_tpu.py:_planar_dc_jnp: SATD of modes [0, 1, 18, 50], (P, 4)."""
    dev = tu.device
    P = tu.shape[0]
    log2w, log2h = I.floor_log2(w), I.floor_log2(h)
    ut, ul = (tf, lf) if w * h > 32 else (tu, lu)
    t = ut[:, 1:w + 1]
    le = ul[:, 1:h + 1]
    br = ul[:, h + 1]
    tr = ut[:, w + 1]
    y1 = _i32(np.arange(1, h + 1)[:, None], dev)
    x1 = _i32(np.arange(1, w + 1)[None, :], dev)
    hor = (le << log2w)[:, :, None] + x1[None] * (tr[:, None] - le)[:, :, None]
    ver = (t << log2h)[:, None, :] + y1[None] * (br[:, None] - t)[:, None, :]
    pl = ((hor << log2h) + (ver << log2w) + (1 << (log2w + log2h))) >> (
        1 + log2w + log2h)
    pl = _pdpc_planar_dc(pl, ut, ul, w, h)
    denom = (w << 1) if w == h else max(w, h)
    shift = I.floor_log2(denom)
    s = torch.zeros((P,), dtype=torch.int32, device=dev)
    if w >= h:
        s = s + tu[:, 1:1 + w].sum(dim=1, dtype=torch.int32)
    if w <= h:
        s = s + lu[:, 1:1 + h].sum(dim=1, dtype=torch.int32)
    dcv = (s + (denom >> 1)) >> shift
    dc = _pdpc_planar_dc(dcv[:, None, None].expand(P, h, w), tu, lu, w, h)
    scale = (log2w + log2h - 2) >> 2
    xr = np.arange(w)
    nxv = min(3 << scale, w)
    wlv = _i32(np.where(xr < nxv, 32 >> np.minimum(31, (2 * xr) >> scale), 0), dev)
    tl = tu[:, 0][:, None, None]
    lcol = lu[:, 1:h + 1][:, :, None]
    ver_p = (tu[:, None, 1:w + 1] + ((wlv[None, None, :] * (lcol - tl) + 32) >> 6)
             ).clamp(0, maxv)
    yr = np.arange(h)
    nxh = min(3 << scale, h)
    wlh = _i32(np.where(yr < nxh, 32 >> np.minimum(31, (2 * yr) >> scale), 0), dev)
    trow = tu[:, 1:w + 1][:, None, :]
    hor_p = (lu[:, 1:h + 1][:, :, None] + ((wlh[None, :, None] * (trow - tl) + 32) >> 6)
             ).clamp(0, maxv)
    preds = torch.stack([pl, dc, hor_p, ver_p], dim=1)  # (P, 4, h, w)
    return satd_batch_plain(preds - src[:, None], h, w)


def _mip(tu, lu, src, w: int, h: int, bit_depth: int, wadj):
    """rmd_tpu.py:_mip_jnp: (P, 2 n_mip) SATD, [(m0,F),(m0,T),(m1,F),..]."""
    size_id = I.mip_size_id(w, h)
    bdry = 2 if size_id == 0 else 4
    red = 4 if size_id < 2 else 8
    up_h, up_v = w // red, h // red
    maxv = (1 << bit_depth) - 1
    t1 = tu[:, 1:w + 1]
    l1 = lu[:, 1:h + 1]
    P = tu.shape[0]

    def dsmp(full, n):
        ln = full.shape[1]
        if n < ln:
            fct = ln // n
            lf = I.floor_log2(fct)
            return (full.reshape(P, n, fct).sum(dim=2, dtype=torch.int32)
                    + (1 << (lf - 1))) >> lf
        return full[:, :n]

    tr_red, lr_red = dsmp(t1, bdry), dsmp(l1, bdry)
    half = 1 << (bit_depth - 1)
    reds, offs = [], []
    for trp in (False, True):
        r = torch.cat([lr_red, tr_red] if trp else [tr_red, lr_red], dim=1)
        off0 = r[:, 0]
        r = r - off0[:, None]
        first = (half - off0) if size_id < 2 else torch.zeros_like(off0)
        reds.append(torch.cat([first[:, None], r[:, 1:]], dim=1))
        offs.append(off0)
    inp = torch.stack(reds, dim=1)  # (P, 2, input_size)
    ioff = torch.stack(offs, dim=1)  # (P, 2)
    n_modes = wadj.shape[0]
    s = inp.sum(dim=2, dtype=torch.int32)
    offset = (1 << (I.MIP_SHIFT_MATRIX - 1)) - I.MIP_OFFSET_MATRIX * s
    # exact int32 product sum over the boundary inputs (no matmul)
    acc = (inp[:, :, None, None, :] * wadj[None, None]).sum(dim=-1, dtype=torch.int32)
    res = (((acc + offset[:, :, None, None]) >> I.MIP_SHIFT_MATRIX)
           + ioff[:, :, None, None]).clamp(0, maxv)
    res = res.reshape(P, 2, n_modes, red, red)
    res = torch.stack([res[:, 0], res[:, 1].transpose(-1, -2)], dim=1)
    dev = tu.device
    if up_h > 1:
        lf = I.floor_log2(up_h)
        off = 1 << (lf - 1)
        k = torch.as_tensor(np.arange(w) // up_h, device=dev)
        pos = _i32(np.arange(w) % up_h, dev)
        bsel = torch.as_tensor((np.arange(red) + 1) * up_v - 1, device=dev)
        before_b = l1[:, bsel][:, None, None, :, None]
        prev = torch.cat([before_b.expand(*res.shape[:-1], 1), res[..., :-1]], dim=-1)
        res = (prev[..., k] * (up_h - 1 - pos) + res[..., k] * (pos + 1) + off) >> lf
    if up_v > 1:
        lf = I.floor_log2(up_v)
        off = 1 << (lf - 1)
        k = torch.as_tensor(np.arange(h) // up_v, device=dev)
        pos = _i32(np.arange(h) % up_v, dev)[:, None]
        bnd = t1[:, None, None, None, :]
        prev = torch.cat([bnd.expand(*res.shape[:-2], 1, res.shape[-1]),
                          res[..., :-1, :]], dim=-2)
        res = (prev[..., k, :] * (up_v - 1 - pos) + res[..., k, :] * (pos + 1)
               + off) >> lf
    c = satd_batch_plain(res - src[:, None, None], h, w)  # (P, 2, M)
    return c.transpose(1, 2).reshape(P, 2 * n_modes)


def reduce_plain(out: torch.Tensor, n_mip: int) -> torch.Tensor:
    """The reference's fused per-position reduction (rmd_tpu.py L579-589)."""
    ang = out[:, :N_ANG]
    P = out.shape[0]
    red = [ang.min(dim=1).values, ang.argmin(dim=1).to(torch.int32), ang[:, 0]]
    if n_mip:
        mip = out[:, N_ANG:]
        red += [mip.min(dim=1).values, mip.argmin(dim=1).to(torch.int32)]
    else:
        red += [torch.full((P,), NO_MIP, dtype=torch.int32, device=out.device),
                torch.zeros((P,), dtype=torch.int32, device=out.device)]
    return torch.stack(red, dim=1)


def _window(srcpad, xs, ys, w: int, h: int):
    """(tu, lu, src) of the positions: the top row (2w+1) and left column
    (2h+1) from the corner, and the block, with indices clamped as jax
    clamps gathers."""
    dev = srcpad.device
    Hp, Wp = srcpad.shape
    ys, xs = ys.long(), xs.long()
    iw = torch.arange(2 * w + 1, device=dev)
    ih = torch.arange(2 * h + 1, device=dev)
    tu = srcpad[clamp_index(ys[:, None], Hp), clamp_index(xs[:, None] + iw, Wp)]
    lu = srcpad[clamp_index(ys[:, None] + ih, Hp), clamp_index(xs[:, None], Wp)]
    ry = torch.arange(1, h + 1, device=dev)[None, :, None]
    rx = torch.arange(1, w + 1, device=dev)[None, None, :]
    src = srcpad[clamp_index(ys[:, None, None] + ry, Hp),
                 clamp_index(xs[:, None, None] + rx, Wp)]
    return tu, lu, src


def _angular_chunk(srcpad, xs, ys, consts: ClassConsts, w: int, h: int,
                   bit_depth: int):
    maxv = (1 << bit_depth) - 1
    tu, lu, src = _window(srcpad, xs, ys, w, h)
    tf, lf = _filter_refs(tu, lu, w, h)
    zero = torch.zeros((tu.shape[0], 1), dtype=torch.int32, device=srcpad.device)
    C = torch.cat([tu, lu, tf, lf, zero], dim=1)
    cols = [_planar_dc(tu, lu, tf, lf, src, w, h, maxv)]
    for g in consts.groups:
        acc = torch.zeros((C.shape[0],) + tuple(g["scidx"].shape),
                          dtype=torch.int32, device=srcpad.device)
        for t in range(4):
            acc += g["f"][None, :, :, None, t] * C[:, g["cidx"][..., t]]
        pred = ((acc + 32) >> 6).clamp(0, maxv)
        side = C[:, g["scidx"]]
        # PDPC with no clip after it, as the reference
        pred = pred + ((g["wl"][None, :, None, :] * (side - pred) + 32) >> 6)
        # the hor group predicts the transposed block
        cmp_src = src if g["ver"] else src.transpose(-1, -2)
        cols.append(satd_batch_plain(pred - cmp_src[:, None], g["dh"], g["dw"]))
    return torch.cat(cols, dim=1)


def _mip_chunk(srcpad, xs, ys, consts: ClassConsts, w: int, h: int,
               bit_depth: int):
    tu, lu, src = _window(srcpad, xs, ys, w, h)
    return _mip(tu, lu, src, w, h, bit_depth, consts.wadj)


def _chunked(fn, ncols: int, srcpad, xs, ys, consts, w, h, bit_depth):
    """fn over the positions, CHUNK sample-mode products at a time."""
    step = max(1, CHUNK // (w * h * ncols))
    outs = [fn(srcpad, xs[i:i + step], ys[i:i + step], consts, w, h, bit_depth)
            for i in range(0, xs.shape[0], step)]
    if not outs:
        return torch.zeros((0, ncols), dtype=torch.int32, device=srcpad.device)
    return torch.cat(outs)


def angular_costs_plain(srcpad, xs, ys, consts: ClassConsts, w: int, h: int,
                        bit_depth: int):
    """out[:, :67] of the class function, in torch int32 ops."""
    return _chunked(_angular_chunk, N_ANG, srcpad, xs, ys, consts, w, h, bit_depth)


def mip_costs_plain(srcpad, xs, ys, consts: ClassConsts, w: int, h: int,
                    bit_depth: int):
    """out[:, 67:] of the class function with MIP, in torch int32 ops."""
    return _chunked(_mip_chunk, 2 * consts.n_mip, srcpad, xs, ys, consts, w, h,
                    bit_depth)


def class_costs_plain(srcpad, xs, ys, consts: ClassConsts, w: int, h: int,
                      bit_depth: int, with_mip: bool):
    """(out, red) of one class at positions (xs, ys) of srcpad."""
    _check_class(consts, w, h, bit_depth, with_mip)
    out = angular_costs_plain(srcpad, xs, ys, consts, w, h, bit_depth)
    if with_mip:
        out = torch.cat([out, mip_costs_plain(srcpad, xs, ys, consts, w, h,
                                              bit_depth)], dim=1)
    return out, reduce_plain(out, consts.n_mip)


def _check_class(consts: ClassConsts, w, h, bit_depth, with_mip) -> None:
    if (w, h, bit_depth, with_mip) != (consts.w, consts.h, consts.bit_depth,
                                       consts.with_mip):
        raise ValueError(f"tables of class {consts.w}x{consts.h} "
                         f"(bit depth {consts.bit_depth}, MIP {consts.with_mip}) "
                         f"for {w}x{h} (bit depth {bit_depth}, MIP {with_mip})")


def _check_positions(srcpad, xs, ys, out, consts: ClassConsts):
    dev = srcpad.device
    P = xs.shape[0]
    KN.check(srcpad, "srcpad", torch.int32, dev)
    KN.check(xs, "xs", torch.int32, dev, (P,))
    KN.check(ys, "ys", torch.int32, dev, (P,))
    KN.check(out, "out", torch.int32, dev, (P, consts.ncols))
    return (srcpad.data_ptr(), *srcpad.shape, xs.data_ptr(), ys.data_ptr(), P)


def angular_costs_cuda(srcpad, xs, ys, consts: ClassConsts, out):
    """vtm_rmd_angular: writes out[:, :67] (out is (P, ncols) int32)."""
    pos = _check_positions(srcpad, xs, ys, out, consts)
    KN.check(consts.tab, "class table", torch.int32, srcpad.device)
    if pos[-1]:
        KN.launch("vtm_rmd_angular", srcpad.device, *pos, consts.tab.data_ptr(),
                  consts.w, consts.h, consts.bit_depth, out.data_ptr(),
                  consts.ncols)
    return out


def mip_costs_cuda(srcpad, xs, ys, consts: ClassConsts, out):
    """vtm_rmd_mip: writes out[:, 67:] (out is (P, ncols) int32)."""
    pos = _check_positions(srcpad, xs, ys, out, consts)
    KN.check(consts.wadj, "wadj", torch.int32, srcpad.device)
    if pos[-1]:
        KN.launch("vtm_rmd_mip", srcpad.device, *pos, consts.wadj.data_ptr(),
                  consts.n_mip, consts.w, consts.h, consts.bit_depth,
                  out.data_ptr(), consts.ncols)
    return out


def reduce_cuda(out, n_mip: int):
    """vtm_rmd_reduce: red (P, 5) of a (P, 67 + 2 n_mip) cost table."""
    dev = out.device
    P = out.shape[0]
    KN.check(out, "out", torch.int32, dev, (P, N_ANG + 2 * n_mip))
    red = torch.empty((P, 5), dtype=torch.int32, device=dev)
    if P:
        KN.launch("vtm_rmd_reduce", dev, out.data_ptr(), P, out.shape[1],
                  2 * n_mip, red.data_ptr())
    return red


def kernel_config(w: int, h: int, lib=None) -> dict:
    """The launch shape of class (w, h)'s two kernels on the current card:
    {"angular": {...}, "mip": {...}} with the fields of CONFIG_FIELDS
    (resident blocks from cudaOccupancyMaxActiveBlocksPerMultiprocessor,
    registers and local bytes from cudaFuncGetAttributes).  `lib`: another
    build of csrc/rmd.cu with the same entry point."""
    lib = lib or KN.library()
    buf = (ctypes.c_int * (2 * len(CONFIG_FIELDS)))()
    err = lib.vtm_rmd_config(w, h, ctypes.cast(buf, ctypes.c_void_p))
    if err:
        raise RuntimeError(f"vtm_rmd_config({w}, {h}): CUDA error {err}")
    n = len(CONFIG_FIELDS)
    return {k: dict(zip(CONFIG_FIELDS, buf[i * n:(i + 1) * n]))
            for i, k in enumerate(("angular", "mip"))}


def class_costs_cuda(srcpad, xs, ys, consts: ClassConsts, w: int, h: int,
                     bit_depth: int, with_mip: bool):
    """(out, red) through csrc/rmd.cu: vtm_rmd_angular, vtm_rmd_mip (with
    MIP) and vtm_rmd_reduce."""
    _check_class(consts, w, h, bit_depth, with_mip)
    out = torch.empty((xs.shape[0], consts.ncols), dtype=torch.int32,
                      device=srcpad.device)
    angular_costs_cuda(srcpad, xs, ys, consts, out)
    if with_mip:
        mip_costs_cuda(srcpad, xs, ys, consts, out)
    return out, reduce_cuda(out, consts.n_mip)


def class_costs(srcpad, xs, ys, consts: ClassConsts, w: int, h: int,
                bit_depth: int, with_mip: bool):
    """RMD costs of one class: the CUDA kernels for CUDA tensors, the plain
    version for CPU tensors."""
    fn = pick(srcpad, class_costs_cuda, class_costs_plain)
    return fn(srcpad, xs, ys, consts, w, h, bit_depth, with_mip)


# ---------------------------------------------------------------------------
# frame-level tables


class FrameRMD:
    """Per-frame RMD cost tables (the reference's interface: `stats`,
    `costs`, `prefetch_rows`, `_force`, `_force_reduced`, `_full`, `_rows`).

    The source is uploaded once; every class's full table stays on the
    device; the reductions of all classes come back in one copy and the
    prefetched rows in one more, so a frame costs the host two syncs."""

    def __init__(self, src_y: np.ndarray, cfg, lam_sqrt: float,
                 device="cuda"):
        self.cfg = cfg
        self.bit_depth = cfg.bit_depth
        h, w = src_y.shape
        self.pic_w, self.pic_h = w, h
        self.device = resolve_device(device)
        srcpad = np.pad(src_y.astype(np.int32), ((1, PAD_R), (1, PAD_R)),
                        mode="edge")
        self._build(srcpad, cfg)

    def _build(self, srcpad, cfg):
        w, h = self.pic_w, self.pic_h
        jobs = []
        for (cw, ch) in intra_class_list(cfg):
            if cw > w or ch > h:
                continue
            sx, sy = _class_strides(cw, ch)
            xs = np.arange(0, w - cw + 1, sx, dtype=np.int32)
            ys = np.arange(0, h - ch + 1, sy, dtype=np.int32)
            if len(xs) == 0 or len(ys) == 0:
                continue
            gx, gy = np.meshgrid(xs, ys)
            jobs.append((cw, ch, gx.ravel(), gy.ravel()))
        dev = upload([srcpad] + [a for j in jobs for a in j[2:]], self.device)
        sp = dev[0]
        self._classes = {}
        self._flat = None
        self._full = {}
        self._red_dev = {}
        self._stats = None
        self._rows: dict = {}
        for k, (cw, ch, fx, fy) in enumerate(jobs):
            with_mip = bool(cfg.mip) and cw <= 64 and ch <= 64
            consts = class_consts(cw, ch, self.bit_depth, with_mip, self.device)
            out, red = class_costs(sp, dev[1 + 2 * k], dev[2 + 2 * k], consts,
                                   cw, ch, self.bit_depth, with_mip)
            idx = {(int(x), int(y)): i for i, (x, y) in enumerate(zip(fx, fy))}
            perm = np.empty(N_ANG, np.int64)
            perm[consts.mode_order] = np.arange(N_ANG)
            self._classes[(cw, ch)] = (idx, len(fx), consts.ncols,
                                       consts.ncols - N_ANG, perm,
                                       consts.mode_order)
            self._full[(cw, ch)] = out
            self._red_dev[(cw, ch)] = red

    @staticmethod
    def _fetch(tensors) -> list[np.ndarray]:
        """Device tensors to numpy in one copy."""
        if not tensors:
            return []
        flat = torch.cat([t.reshape(-1) for t in tensors]).cpu().numpy()
        out, pos = [], 0
        for t in tensors:
            out.append(flat[pos:pos + t.numel()].reshape(tuple(t.shape)))
            pos += t.numel()
        return out

    def _force_reduced(self):
        if self._stats is None:
            keys = list(self._red_dev)
            vals = self._fetch([self._red_dev[k] for k in keys])
            self._stats = {}
            for k, red in zip(keys, vals):
                idx, p, ncols, nm, perm, mode_order = self._classes[k]
                self._stats[k] = (red[:, 0], mode_order[red[:, 1]], red[:, 2],
                                  red[:, 3] if nm else None, red[:, 4])
            self._red_dev = {}
        return self._stats

    def stats(self, x: int, y: int, w: int, h: int):
        """Per-position summary (min_ang, best_mode, planar, min_mip,
        mip_idx) from the reduced device fetch, or None."""
        entry = self._classes.get((w, h))
        if entry is None:
            return None
        i = entry[0].get((x, y))
        if i is None:
            return None
        s = self._force_reduced()[(w, h)]
        return (int(s[0][i]), int(s[1][i]), int(s[2][i]),
                int(s[3][i]) if s[3] is not None else None, int(s[4][i]))

    def prefetch_rows(self, reqs):
        """Gather the full mode-cost rows of the given (x, y, w, h) leaf
        positions on the device and fetch them in one copy; later costs()
        calls for them are host-local."""
        if not self._full or not reqs:
            return
        per_class: dict = {}
        for (x, y, w, h) in reqs:
            entry = self._classes.get((w, h))
            if entry is None:
                continue
            i = entry[0].get((x, y))
            if i is None or (x, y, w, h) in self._rows:
                continue
            per_class.setdefault((w, h), []).append(((x, y, w, h), i))
        if not per_class:
            return
        ridx = upload([np.array([i for _, i in lst]) for lst in per_class.values()],
                      self.device)
        gathers = [self._full[k][r.long()] for k, r in zip(per_class, ridx)]
        for (k, lst), rows in zip(per_class.items(), self._fetch(gathers)):
            perm = self._classes[k][4]
            for (key, _), row in zip(lst, rows):
                self._rows[key] = (row[perm], row[N_ANG:])

    def _force(self):
        if self._flat is None and self._full:
            keys = list(self._full)
            self._flat = dict(zip(keys, self._fetch([self._full[k] for k in keys])))
        return self._flat

    def costs(self, x: int, y: int, w: int, h: int):
        """(angular_costs[67], mip_costs[nm*2]) numpy rows or None."""
        entry = self._classes.get((w, h))
        if entry is None:
            return None
        idx, p, ncols, nm, perm = entry[:5]
        i = idx.get((x, y))
        if i is None:
            return None
        hit = self._rows.get((x, y, w, h))
        if hit is not None:
            return hit
        row = self._force()[(w, h)][i]
        return row[perm], row[N_ANG:]
