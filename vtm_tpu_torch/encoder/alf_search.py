"""ALF parameter search (EncoderLib/EncAdaptiveLoopFilter.cpp analogue).

TPU-first recast of VTM's ALF training: instead of the reference's
per-pixel covariance accumulation loops (EncAdaptiveLoopFilter.cpp,
deriveStatsForFiltering / getBlkStats), the 12 diamond-tap regressor
planes are computed as whole-picture vectorized shifts and reduced into
per-(class, transpose) normal equations with batched matrix products —
the filter derivation is then a bank of 12x12 least-squares solves, the
class merge (mergeClasses analogue) a greedy pairwise reduction over the
same normal equations.  Distortion for the CTU on/off decisions uses the
exact integer filter (ops/alf.py), so encoder RD sees true decode output.

Scope (v1): linear (non-clipped) filters, one luma APS filter bank +
one chroma alternative, CTU on/off RD with re-derivation iteration.
Nonlinear clip search and CC-ALF training are future work.
"""

from __future__ import annotations

import numpy as np

from vtm_tpu_torch.decoder.vlc import AlfParam
from vtm_tpu_torch.common.params import APS
from vtm_tpu_torch.ops import alf as ALF
from vtm_tpu_torch.ops.alf import PAD, _TR7

# canonical (transpose-0) 7x7 diamond taps as (vertical offset, dx);
# e_k = (S[y+vy, x+dx] - c) + (S[y-vy, x-dx] - c)  [filter_block taps]
_LUMA_TAPS = [(3, 0), (2, 1), (2, 0), (2, -1), (1, 2), (1, 1), (1, 0),
              (1, -1), (1, -2), (0, 3), (0, 2), (0, 1)]
_CHROMA_TAPS = [(2, 0), (1, 1), (1, 0), (1, -1), (0, 2), (0, 1)]

_FACTOR = 1 << 7  # fixed center weight (NUM_BITS-1 fractional bits)
_CMAX = 127

# luma filter counts tried in the merge-RD sweep (subset of 1..25 for speed)
_COUNTS = (1, 2, 3, 4, 6, 8, 12, 17, 25)


def _tap_planes(pad: np.ndarray, h: int, w: int, taps) -> np.ndarray:
    """(n_taps, h, w) regressor planes from a PAD-padded plane."""
    cur = pad[PAD:PAD + h, PAD:PAD + w].astype(np.int64)
    out = np.empty((len(taps), h, w), dtype=np.int64)
    for k, (vy, dx) in enumerate(taps):
        a = pad[PAD + vy:PAD + vy + h, PAD + dx:PAD + dx + w].astype(np.int64)
        b = pad[PAD - vy:PAD - vy + h, PAD - dx:PAD - dx + w].astype(np.int64)
        out[k] = a + b - 2 * cur
    return out


def _vb_row_mask(h: int, vb_ctu: int, vb_pos: int, rng: int) -> np.ndarray:
    """True for rows whose taps/shift are VB-modified (excluded from stats)."""
    yvb = np.arange(h) & (vb_ctu - 1)
    return (yvb >= vb_pos - rng) & (yvb <= vb_pos + rng - 1)


def _ls_err(X, y, ss):
    """Minimum SSE of the real-valued LS solution (ridge-stabilised)."""
    n = X.shape[0]
    Xr = X + np.eye(n) * (1e-7 * max(1.0, np.trace(X) / n))
    try:
        c = np.linalg.solve(Xr, y)
    except np.linalg.LinAlgError:
        return ss, np.zeros(n)
    return ss - float(y @ c), c


def _quant_coeffs(X, y, ss, n_taps):
    """Quantize the LS solution to 7-bit fractional ints with greedy ±1
    refinement (xDeriveCoeffQuant analogue)."""
    _, c = _ls_err(X, y, ss)
    q = np.clip(np.round(c * _FACTOR), -_CMAX, _CMAX).astype(np.int64)

    def qerr(qv):
        cf = qv.astype(np.float64) / _FACTOR
        return ss - 2.0 * float(cf @ y) + float(cf @ X @ cf)

    best = qerr(q)
    for _ in range(2):
        improved = False
        for i in range(n_taps):
            for dlt in (1, -1):
                q[i] += dlt
                if abs(q[i]) <= _CMAX:
                    e = qerr(q)
                    if e < best - 1e-9:
                        best = e
                        improved = True
                        continue
                q[i] -= dlt
        if not improved:
            break
    return q, best


def _merge_classes(X, y, ss, n_cls):
    """Greedy class merge (EncAdaptiveLoopFilter::mergeClasses analogue).

    Returns {count: (assignment array, [(Xg, yg, ssg), ...])}."""
    groups = [[i] for i in range(n_cls)]
    stats = [(X[i].copy(), y[i].copy(), ss[i]) for i in range(n_cls)]
    errs = [_ls_err(*stats[i])[0] for i in range(n_cls)]
    out = {}

    def record():
        assign = np.zeros(n_cls, dtype=np.int64)
        for gi, members in enumerate(groups):
            for m in members:
                assign[m] = gi
        out[len(groups)] = (assign, [s for s in stats])

    record()
    while len(groups) > 1:
        best = None
        for i in range(len(groups)):
            for j in range(i + 1, len(groups)):
                Xm = stats[i][0] + stats[j][0]
                ym = stats[i][1] + stats[j][1]
                sm = stats[i][2] + stats[j][2]
                em, _ = _ls_err(Xm, ym, sm)
                inc = em - errs[i] - errs[j]
                if best is None or inc < best[0]:
                    best = (inc, i, j, (Xm, ym, sm), em)
        _, i, j, merged, em = best
        groups[i] = groups[i] + groups[j]
        stats[i] = merged
        errs[i] = em
        del groups[j], stats[j], errs[j]
        record()
    return out


def _ue_bits(v: int) -> int:
    return 2 * (v + 1).bit_length() - 1


def _coeff_rate_bits(q) -> int:
    return sum(_ue_bits(abs(int(c))) + (1 if c else 0) for c in q)


class _LumaDerivation:
    def __init__(self, num_filters, assign, coeff_rows, err):
        self.num_filters = num_filters
        self.assign = assign
        self.coeff_rows = coeff_rows  # (num_filters, 12) int
        self.err = err
        self.rate = 0


def _derive_luma_filters(X, y, ss, lam):
    """Merge sweep + per-count quantization; returns best _LumaDerivation."""
    merged = _merge_classes(X, y, ss, 25)
    best = None
    for count in _COUNTS:
        if count not in merged:
            continue
        assign, stats = merged[count]
        rows, err, rate = [], 0.0, _ue_bits(count - 1)
        if count > 1:
            rate += 25 * max(1, (count - 1).bit_length())
        for Xg, yg, sg in stats:
            q, e = _quant_coeffs(Xg, yg, sg, 12)
            rows.append(q)
            err += e
            rate += _coeff_rate_bits(q)
        cost = err + lam * rate
        if best is None or cost < best[0]:
            d = _LumaDerivation(count, assign, np.array(rows), err)
            d.rate = rate
            best = (cost, d)
    return best[1]


def alf_search(dcs, shim, src_planes, lam):
    """Search ALF parameters for the current picture.

    shim.planes are the post-deblock/post-SAO reconstruction; on return,
    shim carries alf_ctb_flag / alf_ctb_filter_index / alf_ctb_alt and the
    chosen AlfParam is installed in dcs.aps_map[(0, aps_id)].  Returns the
    AlfParam (or None when ALF is RD-off for the picture); the caller
    applies the filter via ops.alf.alf_picture and writes the APS NAL.
    """
    sps = dcs.sps
    bd = sps.bit_depth
    ctu = sps.ctu_size
    fmt = dcs.chroma_format
    H, W = dcs.pic_h, dcs.pic_w
    w_ctu, h_ctu = dcs.pic_w_ctu, dcs.pic_h_ctu
    n_ctu = w_ctu * h_ctu
    vb_pos = ctu - 4

    rec_pad = np.pad(shim.planes[0], PAD, mode="edge")
    org = src_planes[0].astype(np.int64)
    rec = shim.planes[0].astype(np.int64)
    diff = org - rec

    # --- classification (exact decode classifier, per CTU) --------------
    cls_map = np.zeros(((H + 3) // 4, (W + 3) // 4), dtype=np.int64)
    tr_map = np.zeros_like(cls_map)
    ctu_class = {}
    for addr in range(n_ctu):
        cx, cy = addr % w_ctu, addr // w_ctu
        x0, y0 = cx * ctu, cy * ctu
        w = min(ctu, W - x0)
        h = min(ctu, H - y0)
        classes, transposes = ALF.classify_block(
            rec_pad, x0, y0, w, h, bd, ctu, vb_pos)
        ctu_class[addr] = (classes, transposes)
        cls_map[y0 // 4:(y0 + h + 3) // 4, x0 // 4:(x0 + w + 3) // 4] = classes
        tr_map[y0 // 4:(y0 + h + 3) // 4, x0 // 4:(x0 + w + 3) // 4] = transposes

    cls_px = np.repeat(np.repeat(cls_map, 4, 0), 4, 1)[:H, :W]
    tr_px = np.repeat(np.repeat(tr_map, 4, 0), 4, 1)[:H, :W]
    taps = _tap_planes(rec_pad, H, W, _LUMA_TAPS)  # (12, H, W)
    row_ok = ~_vb_row_mask(H, ctu, vb_pos, 4)

    def luma_stats(ctu_mask=None):
        """Per-class normal equations, transpose-folded."""
        X = np.zeros((25, 12, 12))
        y = np.zeros((25, 12))
        ss = np.zeros(25)
        valid = np.zeros((H, W), dtype=bool)
        valid[row_ok] = True
        if ctu_mask is not None:
            keep = np.zeros((H, W), dtype=bool)
            for addr in range(n_ctu):
                if ctu_mask[addr]:
                    cx, cy = addr % w_ctu, addr // w_ctu
                    keep[cy * ctu:(cy + 1) * ctu, cx * ctu:(cx + 1) * ctu] = True
            valid &= keep
        Ev = taps[:, valid].T  # (N, 12)
        dv = diff[valid]
        cv = cls_px[valid]
        tv = tr_px[valid]
        for c in range(25):
            for t in range(4):
                sel = (cv == c) & (tv == t)
                if not sel.any():
                    continue
                Es = Ev[sel]
                perm = _TR7[t][:12]
                Ep = np.empty_like(Es)
                Ep[:, perm] = Es
                X[c] += Ep.T @ Ep
                y[c] += Ep.T @ dv[sel]
                ss[c] += float((dv[sel] ** 2).sum())
        return X, y, ss

    def build_param(deriv, chroma_q):
        p = AlfParam()
        p.new_filter_luma = deriv is not None
        if deriv is not None:
            p.num_luma_filters = deriv.num_filters
            p.filter_coeff_delta_idx = [int(v) for v in deriv.assign] + [0] * 0
            for f in range(deriv.num_filters):
                p.luma_coeff[f] = [int(v) for v in deriv.coeff_rows[f]] + [_FACTOR]
        p.new_filter_chroma = chroma_q is not None
        if chroma_q is not None:
            p.num_alternatives_chroma = 1
            p.chroma_coeff[0] = [int(v) for v in chroma_q] + [_FACTOR]
        return p

    def luma_ctu_decide(param):
        """Exact-integer filtering per CTU → on/off flags + SSD deltas."""
        coeffs, clips = ALF.reconstruct_luma_coeffs(param, bd)
        flags = np.zeros(n_ctu, dtype=np.int64)
        gain = 0.0
        bits_on, bits_off = 2.0, 1.0  # flag + use_prev bin (approx)
        for addr in range(n_ctu):
            cx, cy = addr % w_ctu, addr // w_ctu
            x0, y0 = cx * ctu, cy * ctu
            w = min(ctu, W - x0)
            h = min(ctu, H - y0)
            classes, transposes = ctu_class[addr]
            tmp = rec[y0:y0 + h, x0:x0 + w].copy()
            hold = np.zeros((H, W), dtype=np.int64)
            ALF.filter_block(rec_pad, hold, x0, y0, w, h, True,
                             classes, transposes, coeffs, clips, bd, ctu, vb_pos)
            filt = hold[y0:y0 + h, x0:x0 + w]
            o = org[y0:y0 + h, x0:x0 + w]
            ssd_off = float(((o - tmp) ** 2).sum())
            ssd_on = float(((o - filt) ** 2).sum())
            if ssd_on + lam * bits_on < ssd_off + lam * bits_off:
                flags[addr] = 1
                gain += (ssd_off + lam * bits_off) - (ssd_on + lam * bits_on)
        return flags, gain

    # --- luma: derive → decide → re-derive from enabled CTUs ------------
    X, y, ss = luma_stats()
    deriv = _derive_luma_filters(X, y, ss, lam)
    param = build_param(deriv, None)
    flags, gain = luma_ctu_decide(param)
    if flags.any():
        X2, y2, ss2 = luma_stats(flags)
        deriv2 = _derive_luma_filters(X2, y2, ss2, lam)
        param2 = build_param(deriv2, None)
        flags2, gain2 = luma_ctu_decide(param2)
        if gain2 > gain:
            deriv, param, flags, gain = deriv2, param2, flags2, gain2

    luma_on = bool(flags.any()) and gain > lam * deriv.rate
    if not luma_on:
        flags = np.zeros(n_ctu, dtype=np.int64)

    # --- chroma ----------------------------------------------------------
    chroma_q = None
    ch_flags = [np.zeros(n_ctu, dtype=np.int64), np.zeros(n_ctu, dtype=np.int64)]
    n_comp = fmt.num_components
    if luma_on and n_comp > 1:
        sxc, syc = fmt.scale_x, fmt.scale_y
        Hc, Wc = H >> syc, W >> sxc
        vbc_ctu = ctu >> syc
        vbc_pos = vbc_ctu - 2
        row_ok_c = ~_vb_row_mask(Hc, vbc_ctu, vbc_pos, 2)
        Xc = np.zeros((6, 6))
        yc = np.zeros(6)
        ssc = 0.0
        pads, diffs = [], []
        for comp in (1, 2):
            pad_c = np.pad(shim.planes[comp], PAD, mode="edge")
            d_c = src_planes[comp].astype(np.int64) - shim.planes[comp].astype(np.int64)
            pads.append(pad_c)
            diffs.append(d_c)
            tp = _tap_planes(pad_c, Hc, Wc, _CHROMA_TAPS)
            Ev = tp[:, row_ok_c, :].reshape(6, -1).T
            dv = d_c[row_ok_c].ravel()
            Xc += Ev.T @ Ev
            yc += Ev.T @ dv
            ssc += float((dv ** 2).sum())
        q, _ = _quant_coeffs(Xc, yc, ssc, 6)
        if np.any(q):
            trial = build_param(deriv, q)
            ccoef, cclip = ALF.reconstruct_chroma_coeffs(trial, 0, bd)
            for ci, comp in enumerate((1, 2)):
                recc = shim.planes[comp].astype(np.int64)
                orgc = src_planes[comp].astype(np.int64)
                for addr in range(n_ctu):
                    cx, cy = addr % w_ctu, addr // w_ctu
                    x0c = (cx * ctu) >> sxc
                    y0c = (cy * ctu) >> syc
                    wc = min(ctu >> sxc, Wc - x0c)
                    hc = min(ctu >> syc, Hc - y0c)
                    if wc <= 0 or hc <= 0:
                        continue
                    hold = np.zeros((Hc, Wc), dtype=np.int64)
                    ALF.filter_block(pads[ci], hold, x0c, y0c, wc, hc, False,
                                     None, None, ccoef, cclip, bd,
                                     vbc_ctu, vbc_pos)
                    o = orgc[y0c:y0c + hc, x0c:x0c + wc]
                    r0 = recc[y0c:y0c + hc, x0c:x0c + wc]
                    f0 = hold[y0c:y0c + hc, x0c:x0c + wc]
                    if float(((o - f0) ** 2).sum()) + lam * 2 < \
                            float(((o - r0) ** 2).sum()) + lam:
                        ch_flags[ci][addr] = 1
            if ch_flags[0].any() or ch_flags[1].any():
                chroma_q = q

    if not luma_on and chroma_q is None:
        return None

    # --- install params + per-CTU side data ------------------------------
    param = build_param(deriv if luma_on else None, chroma_q)
    aps_id = 0
    aps = APS()
    aps.aps_id = aps_id
    aps.aps_type = 0
    aps.alf = param
    if not hasattr(dcs, "aps_map"):
        dcs.aps_map = {}
    dcs.aps_map[(0, aps_id)] = aps
    sh = dcs.sh
    sh.alf_enabled = [bool(luma_on),
                      bool(chroma_q is not None and ch_flags[0].any()),
                      bool(chroma_q is not None and ch_flags[1].any())]
    sh.num_alf_aps = 1 if luma_on else 0
    sh.alf_aps_ids = [aps_id] if luma_on else []
    sh.alf_aps_id_chroma = aps_id
    shim.alf_ctb_flag = [flags,
                         ch_flags[0] if sh.alf_enabled[1] else np.zeros(n_ctu, dtype=np.int64),
                         ch_flags[1] if sh.alf_enabled[2] else np.zeros(n_ctu, dtype=np.int64)]
    shim.alf_ctb_filter_index = np.full(n_ctu, 16, dtype=np.int64)  # APS slot 0
    shim.alf_ctb_alt = [np.zeros(n_ctu, dtype=np.int64) for _ in range(3)]
    shim.ccalf_control = [np.zeros(n_ctu, dtype=np.int64) for _ in range(2)]
    return param


# ---------------------------------------------------------------------------
# CC-ALF training (EncAdaptiveLoopFilter CC-ALF derivation analogue)

_CC_SCALE = 7  # SCALE_BITS_CC
# per-coefficient codable values: 0 and +-2^k (APS syntax, vlc.py:906-919)
_CC_LEVELS = np.array([0, 1, 2, 4, 8, 16, 32, 64], dtype=np.int64)
_CC_CAND = np.unique(np.concatenate([_CC_LEVELS, -_CC_LEVELS]))


def _cc_tap_diffs(luma_pad, Hc, Wc, sx, sy, ctu, vb_pos):
    """The 7 CC-ALF tap differences (luma neighbour - collocated centre)
    at every chroma position, with the virtual-boundary tap adjustments
    of ops.alf.filter_block_ccalf.  Returns (d (7,Hc,Wc), skip (Hc,) row
    mask of positions the filter leaves untouched)."""
    yl = (np.arange(Hc) << sy)
    xl = (np.arange(Wc) << sx)
    pos = yl & (ctu - 1)
    o1 = np.ones(Hc, np.int64)
    o2 = -np.ones(Hc, np.int64)
    o3 = np.full(Hc, 2, np.int64)
    m = (pos == vb_pos - 2) | (pos == vb_pos + 1)
    o3[m] = o1[m]
    m = (pos == vb_pos - 1) | (pos == vb_pos)
    o1[m] = 0
    o2[m] = 0
    o3[m] = 0
    skip = (sy == 0) & ((pos == vb_pos) | (pos == vb_pos + 1))

    def L(dy_rows, dxc):
        return luma_pad[(PAD + yl + dy_rows)[:, None], (PAD + xl + dxc)[None, :]]

    zero = np.zeros(Hc, np.int64)
    cur = L(zero, 0)
    d = np.stack([
        L(o2, 0) - cur,
        L(zero, -1) - cur,
        L(zero, 1) - cur,
        L(o1, -1) - cur,
        L(o1, 0) - cur,
        L(o1, 1) - cur,
        L(o3, 0) - cur,
    ])
    return d, skip


def derive_ccalf(dcs, shim, src_planes, lam, pre_alf_luma, param):
    """Train one CC-ALF filter per chroma component + per-CTU control.

    Least-squares over the tap differences against the post-ALF chroma
    residual, coefficients snapped to the codable {0, +-2^k} grid, then a
    greedy per-CTU on/off RD with the exact integer filter output.  On
    success installs coefficients in `param`, control maps in
    shim.ccalf_control, and slice-header enables.  The caller must apply
    the returned delta maps to shim.planes (decode-exact)."""
    sps = dcs.sps
    fmt = dcs.chroma_format
    if fmt.num_components < 2 or not getattr(sps, "ccalf", False):
        return
    bd = sps.bit_depth
    ctu = sps.ctu_size
    w_ctu, h_ctu = dcs.pic_w_ctu, dcs.pic_h_ctu
    sh = dcs.sh
    vb_pos = ctu - 4
    maxv = (1 << bd) - 1
    half = (1 << bd) >> 1
    luma_pad = np.pad(pre_alf_luma, PAD, mode="edge").astype(np.int64)
    sx, sy = fmt.scale_x, fmt.scale_y

    for comp in (1, 2):
        orgc = src_planes[comp].astype(np.int64)
        recc = shim.planes[comp].astype(np.int64)
        resid = orgc - recc
        Hc, Wc = recc.shape
        d, skip = _cc_tap_diffs(luma_pad, Hc, Wc, sx, sy, ctu, vb_pos)
        valid = ~skip
        dv = d[:, valid, :].reshape(7, -1).astype(np.float64)
        rv = resid[valid, :].reshape(-1).astype(np.float64)
        A = dv @ dv.T
        b = dv @ (rv * (1 << _CC_SCALE))
        try:
            cf = np.linalg.solve(A + np.eye(7) * 1e-3, b)
        except np.linalg.LinAlgError:
            continue
        # snap to the codable grid (nearest by value), then greedy joint
        # re-fit: per coefficient, try the neighbouring grid values and
        # keep any that lowers the true quadratic LS objective — repairs
        # the coupling the independent per-coefficient snap ignores
        # (cf. the reference's iterative CC-ALF refinement passes)
        q = np.array([_CC_CAND[np.argmin(np.abs(_CC_CAND - v))] for v in cf],
                     dtype=np.int64)

        def ls_obj(qq):
            v = qq.astype(np.float64)
            return float(v @ A @ v - 2.0 * (b @ v))

        best_obj = ls_obj(q)
        for _ in range(2):
            improved = False
            for i in range(7):
                ci = int(np.argmin(np.abs(_CC_CAND - q[i])))
                for cj in (ci - 1, ci + 1):
                    if not (0 <= cj < len(_CC_CAND)):
                        continue
                    trial = q.copy()
                    trial[i] = _CC_CAND[cj]
                    o = ls_obj(trial)
                    if o < best_obj:
                        best_obj, q, improved = o, trial, True
            if not improved:
                break
        if not q.any():
            continue
        # exact integer filter delta over the plane
        s = np.zeros((Hc, Wc), np.int64)
        for i in range(7):
            s += int(q[i]) * d[i]
        s = (s + (1 << (_CC_SCALE - 1))) >> _CC_SCALE
        s = np.clip(s, -half, maxv - half)
        s[skip, :] = 0
        filtered = np.clip(recc + s, 0, maxv)
        delta_on = (orgc - filtered) ** 2
        delta_off = resid ** 2
        control = np.zeros(w_ctu * h_ctu, np.int64)
        sxc, syc = sx, sy
        any_on = False
        for addr in range(w_ctu * h_ctu):
            cx, cy = addr % w_ctu, addr // w_ctu
            x0 = (cx * ctu) >> sxc
            y0 = (cy * ctu) >> syc
            wc = min(ctu >> sxc, Wc - x0)
            hc = min(ctu >> syc, Hc - y0)
            if wc <= 0 or hc <= 0:
                continue
            on = float(delta_on[y0:y0 + hc, x0:x0 + wc].sum())
            off = float(delta_off[y0:y0 + hc, x0:x0 + wc].sum())
            # ~2 bins for the control idc + amortized APS coeff cost
            if on + lam * 2.5 < off + lam * 1.0:
                control[addr] = 1
                any_on = True
        if not any_on:
            continue
        cc = comp - 1
        param.new_ccalf[cc] = True
        param.ccalf_filter_count[cc] = 1
        param.ccalf_enabled_idx[cc][0] = True
        param.ccalf_coeff[cc][0] = [int(v) for v in q]
        shim.ccalf_control[cc] = control
        if comp == 1:
            sh.ccalf_cb_enabled = True
            sh.ccalf_cb_aps_id = 0
        else:
            sh.ccalf_cr_enabled = True
            sh.ccalf_cr_aps_id = 0
        # apply on enabled CTUs (decode-exact)
        for addr in np.nonzero(control)[0]:
            cx, cy = addr % w_ctu, addr // w_ctu
            x0 = (int(cx) * ctu) >> sxc
            y0 = (int(cy) * ctu) >> syc
            wc = min(ctu >> sxc, Wc - x0)
            hc = min(ctu >> syc, Hc - y0)
            blk = filtered[y0:y0 + hc, x0:x0 + wc]
            shim.planes[comp][y0:y0 + hc, x0:x0 + wc] = blk.astype(
                shim.planes[comp].dtype)
