"""Dequantization — exact integer reference implementation.

Behavioral contract from CommonLib/Quant.cpp Quant::dequant:357 (flat
default scaling lists) and QpParam (Quant.cpp/h): per-TU QP derivation with
chroma mapping tables and joint-CbCr offsets.  Scaling-list support lands
with the scaling-list APS.
"""

from __future__ import annotations

import numpy as np

from vtm_tpu_torch.common import rom

IQUANT_SHIFT = 6
G_ICT_MODES = [[0, 3, 1, 2], [0, -3, -1, -2]]  # Rom.cpp:527


def floor_log2(x: int) -> int:
    return x.bit_length() - 1


def qp_param(
    qp_y: int,
    comp: int,
    sps,
    cb_qp_offset: int,
    cr_qp_offset: int,
    joint_qp_offset: int,
    chroma_qp_adj_offsets: tuple[int, int, int],
    use_jqp: bool,
) -> tuple[int, int, int]:
    """Returns (qp, per, rem) for the non-TS path (QpParam)."""
    bd_off = sps.qp_bd_offset
    if comp == 0:
        base = qp_y + bd_off
    else:
        if use_jqp:
            table_idx = 2
            offset = joint_qp_offset + chroma_qp_adj_offsets[2]
        else:
            table_idx = comp - 1
            offset = (cb_qp_offset if comp == 1 else cr_qp_offset) + chroma_qp_adj_offsets[comp - 1]
        qpi = max(-bd_off, min(63, qp_y))
        base = sps.chroma_qp_table.map_qp(table_idx, qpi, bd_off)
        base = max(-bd_off, min(63, base + offset)) + bd_off
    base = max(0, min(63 + bd_off, base))
    return base, base // 6, base % 6


def dequant(
    coeff: np.ndarray,
    qp: tuple[int, int, int],
    bit_depth: int,
    is_ts: bool = False,
    scaling: np.ndarray | None = None,
) -> np.ndarray:
    """Quant::dequant.

    coeff: (h, w) int; qp: (qp, per, rem) from qp_param (TS variant applies
    the max(qpTS) rule before calling).  `scaling`: per-position dequant
    coefficients (inv_scale * matrix entry, scaling_list.dequant_matrix)
    for explicit scaling lists (Quant.cpp:405 enableScalingLists path);
    None = flat list.
    """
    h, w = coeff.shape
    max_range = 15
    tmin, tmax = -(1 << max_range), (1 << max_range) - 1
    transform_shift = max_range - bit_depth - ((floor_log2(w) + floor_log2(h)) >> 1)
    needs_sqrt2 = (not is_ts) and (((floor_log2(w) + floor_log2(h)) & 1) == 1)
    i_transform_shift = transform_shift + (-1 if needs_sqrt2 else 0)
    _, qp_per, qp_rem = qp
    right_shift = IQUANT_SHIFT - ((0 if is_ts else i_transform_shift) + qp_per)
    if scaling is not None:
        right_shift += 4  # LOG2_SCALING_LIST_NEUTRAL_VALUE
        scale = scaling.astype(np.int64)
        scale_bits = 1 + IQUANT_SHIFT + 8  # dequantCoefBits w/ SCALING_LIST_BITS
    else:
        scale = rom.inv_quant_scale(qp_rem, needs_sqrt2)
        scale_bits = IQUANT_SHIFT + 1
    target_bd = min(max_range + 1, 64 + right_shift - scale_bits)
    in_min, in_max = -(1 << (target_bd - 1)), (1 << (target_bd - 1)) - 1
    c = np.clip(coeff.astype(np.int64), in_min, in_max)
    if right_shift > 0:
        add = 1 << (right_shift - 1)
        out = (c * scale + add) >> right_shift
    else:
        out = (c * scale) << (-right_shift)
    return np.clip(out, tmin, tmax).astype(np.int32)


QUANT_SHIFT = 14


def quant_fwd(
    coeff: np.ndarray,
    qp: tuple[int, int, int],
    bit_depth: int,
    is_irap: bool,
    is_ts: bool = False,
) -> np.ndarray:
    """Quant::quant scalar path (RDOQ off, flat lists)."""
    h, w = coeff.shape
    max_range = 15
    transform_shift = max_range - bit_depth - ((floor_log2(w) + floor_log2(h)) >> 1)
    needs_sqrt2 = (not is_ts) and (((floor_log2(w) + floor_log2(h)) & 1) == 1)
    if needs_sqrt2:
        transform_shift -= 1
    _, qp_per, qp_rem = qp
    qbits = QUANT_SHIFT + qp_per + (0 if is_ts else transform_shift)
    scale = rom.quant_scale(qp_rem, needs_sqrt2)
    add = (171 if is_irap else 85) << (qbits - 9)
    c = coeff.astype(np.int64)
    sign = np.where(c < 0, -1, 1)
    mag = (np.abs(c) * scale + add) >> qbits
    return np.clip(sign * mag, -(1 << max_range), (1 << max_range) - 1).astype(np.int32)


import functools


@functools.lru_cache(maxsize=None)
def _scan_col0(w: int, h: int) -> np.ndarray:
    return np.ascontiguousarray(rom.scan(1, w, h)[:, 0], dtype=np.int64)


@functools.lru_cache(maxsize=None)
def _dqi_consts(w: int, h: int, qp0: int, bit_depth: int, is_ts: bool):
    """Derived constants of the dependent-quantization inverse."""
    max_range = 15
    qp_dq = qp0 + 1
    qp_per, qp_rem = qp_dq // 6, qp_dq % 6
    transform_shift = max_range - bit_depth - ((floor_log2(w) + floor_log2(h)) >> 1)
    needs_sqrt2 = (not is_ts) and (((floor_log2(w) + floor_log2(h)) & 1) == 1)
    if needs_sqrt2:
        transform_shift -= 1
    shift = IQUANT_SHIFT + 1 - qp_per - transform_shift
    inv_scale = rom.inv_quant_scale(qp_rem, needs_sqrt2)
    if shift < 0:
        inv_scale <<= -shift
        shift = 0
    add = (1 << shift) >> 1
    return shift, inv_scale, add


def dequant_dep(
    coeff: np.ndarray,
    qp: tuple[int, int, int],
    bit_depth: int,
    scan: np.ndarray,
    is_ts: bool = False,
    scaling: np.ndarray | None = None,
) -> np.ndarray:
    """Dependent-quantization inverse (DepQuant.cpp Quantizer::dequantBlock
    :705): per-coefficient 8-state machine over the scan order with
    qIdx = 2*level -/+ (state>>1) and QP+1 scaling.  `scaling`: explicit
    scaling-list dequant coefficients (dequantBlock enableScalingLists:
    per-position invQScale, +LOG2_SCALING_LIST_NEUTRAL_VALUE shift)."""
    h, w = coeff.shape
    max_range = 15
    tmin, tmax = -(1 << max_range), (1 << max_range) - 1
    flat = coeff.ravel()
    out = np.zeros_like(flat)
    scan_pos = scan[:, 0]
    lv_scan = flat[scan_pos].astype(np.int64)
    nz = np.nonzero(lv_scan)[0]
    if nz.size == 0:
        return out.reshape(h, w)
    shift, inv_scale, add = _dqi_consts(w, h, qp[0], bit_depth, is_ts)
    per_pos_scale = None
    if scaling is not None:
        # recompute shift with the scaling-list neutral offset, without
        # the flat path's shift<0 folding (handled per position below)
        qp_dq = qp[0] + 1
        qp_per = qp_dq // 6
        tshift = max_range - bit_depth - ((floor_log2(w) + floor_log2(h)) >> 1)
        if (not is_ts) and (((floor_log2(w) + floor_log2(h)) & 1) == 1):
            tshift -= 1
        shift = IQUANT_SHIFT + 1 - qp_per - tshift + 4
        per_pos_scale = scaling.ravel().astype(np.int64)
        if shift < 0:
            per_pos_scale = per_pos_scale << (-shift)
            shift = 0
        add = (1 << shift) >> 1
    # state walk over nonzeros only: between them the levels are zero, whose
    # transition T0 = [0,2,1,3] swaps {1,2} per step and fixes {0,3}
    trans = ((0, 2), (2, 0), (1, 3), (3, 1))  # trans[s] = (next|par0, next|par1)
    states = np.empty(nz.size, dtype=np.int64)
    s = 0
    prev = int(nz[-1])  # == last significant scan index; state starts 0 there
    for j in range(nz.size - 1, -1, -1):
        idx = int(nz[j])
        gap = prev - idx - 1  # zero-level positions crossed since previous nz
        if gap > 0 and (gap & 1) and s in (1, 2):
            s = 3 - s
        states[j] = s
        s = trans[s][int(lv_scan[idx]) & 1]
        prev = idx
    lv_nz = lv_scan[nz]
    half = states >> 1
    q_idx = (lv_nz << 1) + np.where(lv_nz > 0, -half, half)
    if per_pos_scale is not None:
        val = (q_idx * per_pos_scale[scan_pos[nz]] + add) >> shift
    else:
        val = (q_idx * int(inv_scale) + add) >> shift
    out[scan_pos[nz]] = np.clip(val, tmin, tmax)
    return out.reshape(h, w)


_DQ_STATE_TRANS = 32040  # DepQuant.cpp state transition table (2 bits/entry)
_DQ_NATIVE = None  # lazily loaded native trellis (False = build failed)


@functools.lru_cache(maxsize=None)
def _dqf_consts(w: int, h: int, qp0: int, bit_depth: int):
    """Derived constants of the forward dependent-quantization trellis."""
    max_range = 15
    lg = (floor_log2(w) + floor_log2(h)) >> 1
    transform_shift = max_range - bit_depth - lg
    needs_sqrt2 = ((floor_log2(w) + floor_log2(h)) & 1) == 1
    d_trans_shift = transform_shift + (-0.5 if needs_sqrt2 else 0.0)
    if needs_sqrt2:
        transform_shift -= 1
    qp_dq = qp0 + 1
    qp_per, qp_rem = qp_dq // 6, qp_dq % 6
    qbits = QUANT_SHIFT + qp_per + transform_shift
    scale = rom.quant_scale(qp_rem, needs_sqrt2)
    err_scale = (2.0 ** (-2.0 * d_trans_shift)) / (scale * scale)
    half = 1 << (qbits - 1)
    return qbits, scale, err_scale, half


def _dq_rate(level: int) -> float:
    """Context-free bin-count model for one coded |level| (sig/gt1/par/gt2 +
    golomb remainder) — encoder-side approximation shared with quant_rdoq."""
    if level == 0:
        return 0.55
    r = 2.0  # sig + sign
    if level == 1:
        return r + 1.0
    if level <= 3:
        return r + 3.0
    rem = (level - 4) >> 1
    return r + 4.0 + 2.0 + float(rem.bit_length() * 2 if rem else 0)


def quant_dep(
    coeff: np.ndarray,
    qp: tuple[int, int, int],
    bit_depth: int,
    lam: float,
    scan: np.ndarray,
) -> np.ndarray:
    """Dependent-quantization trellis (encoder side of DepQuant.cpp
    :806-1008 / quant:1582, re-designed): a 4-state Viterbi over the scan
    order choosing per-coefficient levels so that reconstruction through
    the normative inverse (dequant_dep, QP+1 half-step quantizers Q0/Q1
    selected by state>>1) minimises SSD + lambda*bins.  Non-normative —
    any level choice is legal; reconstruction must use dequant_dep on the
    returned levels.
    """
    h, w = coeff.shape
    max_range = 15
    qbits, scale, err_scale, half = _dqf_consts(w, h, qp[0], bit_depth)

    flat = coeff.ravel()
    n = w * h
    sidx = _scan_col0(w, h)
    mags = np.abs(flat[sidx]).astype(np.int64)  # magnitude per scan pos
    u = mags * scale  # scaled-domain magnitudes
    # candidate last: highest scan pos whose round-to-nearest level is >=1
    nz = np.nonzero((u << 1) >= (1 << qbits))[0]
    if len(nz) == 0:
        return np.zeros_like(coeff, dtype=np.int32)
    last = int(nz[-1])
    INF = float("inf")

    npos = last + 1
    global _DQ_NATIVE
    if _DQ_NATIVE is None:
        from vtm_tpu_torch import native as _native

        _DQ_NATIVE = _native.load_depquant() or False
    if _DQ_NATIVE:
        # coding order: last .. DC
        u_cod = np.ascontiguousarray(u[last::-1], dtype=np.int64)
        lev_cod = np.zeros(npos, dtype=np.int32)
        keep = _DQ_NATIVE.trellis(u_cod, lev_cod, qbits, err_scale, lam)
        out = np.zeros(n, dtype=np.int64)
        if keep:
            lv = lev_cod[::-1].astype(np.int64)  # index by scan pos 0..last
            sgn = np.where(flat[sidx[: last + 1]] < 0, -1, 1)
            out[sidx[: last + 1]] = sgn * lv
        return np.clip(out, -(1 << max_range), (1 << max_range) - 1).astype(
            np.int32).reshape(h, w)
    cost = [0.0, INF, INF, INF]
    back = np.zeros((npos, 4, 2), dtype=np.int64)  # (prev_state, level)
    zero_run_cost = 0.0  # accumulated cost of the all-zero alternative
    for i in range(npos):
        p = last - i  # coding order: last -> DC
        up = float(u[p])
        zero_run_cost += up * up * err_scale
        new = [INF, INF, INF, INF]
        for s in range(4):
            cs = cost[s]
            if cs == INF:
                continue
            hq = s >> 1  # quantizer offset (Q0/Q1)
            l0 = int((int(u[p]) + hq * half) >> qbits)
            cands = (0, l0, l0 + 1) if l0 > 0 else (0, 1)
            for lv in cands:
                if p == last and lv == 0:
                    continue  # last position is signalled significant
                if lv > 0:
                    q_idx = 2 * lv - hq
                    e = up - float(q_idx * half)
                else:
                    e = up
                c = cs + e * e * err_scale + lam * _dq_rate(lv)
                ns = (_DQ_STATE_TRANS >> ((s << 2) + ((lv & 1) << 1))) & 3
                if c < new[ns]:
                    new[ns] = c
                    back[i, ns, 0] = s
                    back[i, ns, 1] = lv
        cost = new
    best_s = int(np.argmin(cost))
    best_cost = cost[best_s]
    # compare against dropping the block entirely (caller signals cbf=0)
    if best_cost + lam * 4.0 >= zero_run_cost:
        return np.zeros_like(coeff, dtype=np.int32)
    out = np.zeros(n, dtype=np.int64)
    s = best_s
    for i in range(npos - 1, -1, -1):
        p = last - i
        lv = int(back[i, s, 1])
        if lv:
            sgn = -1 if flat[sidx[p]] < 0 else 1
            out[sidx[p]] = sgn * lv
        s = int(back[i, s, 0])
    return np.clip(out, -(1 << max_range), (1 << max_range) - 1).astype(
        np.int32).reshape(h, w)


def inv_transform_ict(mode: int, resi_cb: np.ndarray, resi_cr: np.ndarray):
    """TrQuant::invTransformICT (TrQuant.cpp:627): joint Cb-Cr inverse.

    mode from G_ICT_MODES[sign][jointCbCr]; input: the decoded residual in
    the coded component; returns (resCb, resCr).
    """
    if mode == 0:
        return resi_cb, resi_cr
    if mode == 1:
        return resi_cb, resi_cb >> 1
    if mode == -1:
        return resi_cb, (-resi_cb) >> 1
    if mode == 2:
        return resi_cb, resi_cb
    if mode == -2:
        # non-normative 16-bit clamp from the reference
        return resi_cb, np.where(resi_cb == -32768, 32767, -resi_cb)
    if mode == 3:
        return resi_cr >> 1, resi_cr
    if mode == -3:
        return (-resi_cr) >> 1, resi_cr
    raise ValueError(mode)


def quant_rdoq(
    coeff: np.ndarray,
    qp: tuple[int, int, int],
    bit_depth: int,
    lam: float,
) -> np.ndarray:
    """Rate-distortion-optimized quantization (QuantRDOQ.cpp behavioral
    approximation): per-coefficient level choice among {0, l, l+1} with the
    reference's errScale distortion weighting (xGetErrScaleCoeff:373) and a
    context-free rate model, plus optimal last-significant-position
    selection.  Purely encoder-side (non-normative)."""
    h, w = coeff.shape
    max_range = 15
    lg = (floor_log2(w) + floor_log2(h)) >> 1
    transform_shift = max_range - bit_depth - lg
    needs_sqrt2 = ((floor_log2(w) + floor_log2(h)) & 1) == 1
    tshift_q = transform_shift - (1 if needs_sqrt2 else 0)
    _, qp_per, qp_rem = qp
    qbits = QUANT_SHIFT + qp_per + tshift_q
    scale = rom.quant_scale(qp_rem, needs_sqrt2)
    # errScale: pixel-domain SSD per unit (a*scale - l<<qbits)^2
    # (xGetErrScaleCoeff with the 2^SCALE_BITS bit-cost scaling folded out
    # since our costs are (pixel SSD) + lam * bits)
    d_trans_shift = transform_shift + (-0.5 if needs_sqrt2 else 0.0)
    err_scale = (2.0 ** (-2.0 * d_trans_shift)) / (scale * scale)

    c = coeff.astype(np.int64)
    sign = np.where(c < 0, -1, 1)
    mag = np.abs(c)
    # candidate levels
    l_low = (mag * scale) >> qbits
    cand = [l_low, l_low + 1]

    def rate(l):
        # approximate bins: sig + sign + coded level bins
        r = np.where(l == 0, 0.55, 2.0)
        r = r + np.where(l == 1, 1.0, 0.0)
        r = r + np.where((l >= 2) & (l <= 3), 3.0, 0.0)
        big = l >= 4
        rem = np.maximum(l - 4, 0)
        r = r + np.where(big, 4.0 + (rem >> 1) + 2.0, 0.0)
        return r

    # distortion for level l: (mag*scale - l<<qbits)^2 scaled to pixel SSD
    def dist(l):
        e = (mag * scale - (l << qbits)).astype(np.float64)
        return e * e * err_scale

    best_l = np.zeros_like(l_low)
    best_cost = dist(0) + lam * rate(np.zeros_like(l_low))
    zero_cost = best_cost.copy()
    for l in cand:
        cst = dist(l) + lam * rate(l)
        better = cst < best_cost
        best_cost = np.where(better, cst, best_cost)
        best_l = np.where(better, l, best_l)
    # optimal last significant position along the scan
    scan = rom.scan(0, w, h)  # (n, 3) idx,x,y
    sx = scan[:, 1].astype(np.int64)
    sy = scan[:, 2].astype(np.int64)
    bl = best_l[sy, sx]
    bc = best_cost[sy, sx]
    zc = zero_cost[sy, sx]
    nz = np.nonzero(bl)[0]
    if len(nz) == 0:
        return np.zeros_like(coeff, dtype=np.int32)
    # cost of coding up to (and including) position p as chosen, rest zero
    delta = bc - zc  # per-position gain of coding the chosen level
    prefix = np.cumsum(delta)
    best_p = None
    best_total = 0.0  # relative to all-zero
    for p in nz:
        # total = sum(delta[0..p]) + approx last-position bits
        total = float(prefix[p]) + lam * (
            1.0 + int(sx[p]).bit_length() + int(sy[p]).bit_length()
        )
        if best_p is None or total < best_total:
            best_p = p
            best_total = total
    if best_total >= 0.0 or best_p is None:
        return np.zeros_like(coeff, dtype=np.int32)
    out = np.zeros_like(coeff, dtype=np.int64)
    keep = np.zeros(len(bl), dtype=bool)
    keep[: best_p + 1] = True
    out[sy[keep], sx[keep]] = bl[keep]
    out = out * sign
    return np.clip(out, -(1 << max_range), (1 << max_range) - 1).astype(np.int32)
