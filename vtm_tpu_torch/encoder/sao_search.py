"""Encoder SAO parameter search (EncSampleAdaptiveOffset equivalent).

Per CTU and component: derive candidate offsets from edge/band statistics
on the deblocked reconstruction, evaluate each candidate's exact
distortion by applying the decoder's own offset kernel, price the syntax
with a CABAC bit estimator twin, and pick argmin(D + lambda*R) among
{off, EO 0/90/135/45, BO, merge-left, merge-up}.
"""

from __future__ import annotations

import copy

import numpy as np

from vtm_tpu_torch.decoder.cabac_reader import SaoParams
from vtm_tpu_torch.ops import sao as SAO


def _derive_eo_offsets(org, rec, dx, dy, max_off):
    """Class-wise (count, diff-sum) for one EO direction on the interior,
    then VTM-style clipped mean offsets (sign-constrained per class)."""
    h, w = rec.shape
    # interior only (borders handled exactly at apply time)
    c = rec[1 : h - 1, 1 : w - 1].astype(np.int64)
    a = rec[1 - dy : h - 1 - dy, 1 - dx : w - 1 - dx].astype(np.int64)
    b = rec[1 + dy : h - 1 + dy, 1 + dx : w - 1 + dx].astype(np.int64)
    edge = np.sign(c - a) + np.sign(c - b)  # -2..2
    diff = org[1 : h - 1, 1 : w - 1].astype(np.int64) - c
    offsets = [0] * 5
    for cls, sign_con in ((-2, 1), (-1, 1), (1, -1), (2, -1)):
        m = edge == cls
        cnt = int(m.sum())
        if not cnt:
            continue
        s = int(diff[m].sum())
        o = int(round(s / cnt))
        if sign_con > 0:
            o = max(0, min(max_off, o))
        else:
            o = min(0, max(-max_off, o))
        offsets[cls + 2] = o
    return offsets


def _derive_bo(org, rec, bd, max_off):
    """32-band stats; best 4 consecutive bands by distortion gain."""
    shift = bd - 5
    bands = (rec >> shift).astype(np.int64)
    diff = org.astype(np.int64) - rec.astype(np.int64)
    cnt = np.bincount(bands.ravel(), minlength=32)[:32]
    ssum = np.bincount(bands.ravel(), weights=diff.ravel(), minlength=32)[:32]
    offs = np.zeros(32, dtype=np.int64)
    gain = np.zeros(32, dtype=np.float64)
    for k in range(32):
        if cnt[k]:
            o = int(round(ssum[k] / cnt[k]))
            o = max(-max_off, min(max_off, o))
            offs[k] = o
            # distortion delta: cnt*o^2 - 2*o*sum  (negative = gain)
            gain[k] = cnt[k] * o * o - 2 * o * ssum[k]
    best_pos, best_gain = 0, 0.0
    for pos in range(32):
        g = sum(gain[(pos + k) % 32] for k in range(4))
        if g < best_gain:
            best_gain, best_pos = g, pos
    out = np.zeros(32, dtype=np.int64)
    for k in range(4):
        idx = (best_pos + k) % 32
        out[idx] = offs[idx]
    return best_pos, [int(v) for v in out]


def sao_search(dcs, pic, src_planes, lam: float, est) -> None:
    """Fill pic.sao_params per CTU. `est` is a BitEstimator whose contexts
    advance with the chosen parameters (CTU raster order); `pic.planes`
    hold the deblocked reconstruction and are SAO-filtered in place at the
    end (via ops.sao.sao_picture)."""
    from vtm_tpu_torch.decoder.cs import Rect
    from vtm_tpu_torch.encoder.cabac_writer import SyntaxWriter

    sps = dcs.sps
    fmt = dcs.chroma_format
    n_comp = fmt.num_components
    bd = sps.bit_depth
    maxv = (1 << bd) - 1
    max_off = min((1 << (min(bd, 10) - 5)) - 1, 31)
    w_ctu, h_ctu = dcs.pic_w_ctu, dcs.pic_h_ctu
    lam_comp = [lam, lam, lam]
    resolved: list[SaoParams | None] = [None] * (w_ctu * h_ctu)
    scratch = [np.empty_like(pl) for pl in pic.planes]

    def apply_region(comp, bx, by, bw, bh, type_idc, offsets, avail):
        sc = scratch[comp]
        sc[by : by + bh, bx : bx + bw] = pic.planes[comp][by : by + bh, bx : bx + bw]
        SAO._offset_block(pic.planes[comp], sc, bx, by, bw, bh, type_idc,
                          offsets, bd, maxv, avail)
        return sc[by : by + bh, bx : bx + bw]

    for addr in range(w_ctu * h_ctu):
        cx, cy = addr % w_ctu, addr // w_ctu
        x0, y0 = cx * sps.ctu_size, cy * sps.ctu_size
        avail = SAO._boundary_avail(dcs, x0, y0)
        rect = Rect(x0, y0, sps.ctu_size, sps.ctu_size)
        cand_params: list[SaoParams] = []
        dirs = ((1, 0), (0, 1), (1, 1), (-1, 1))  # EO 0/90/135/45

        def blk(comp):
            sx = fmt.scale_x if comp else 0
            sy = fmt.scale_y if comp else 0
            bx, by = x0 >> sx, y0 >> sy
            bw = min(sps.ctu_size >> sx, pic.planes[comp].shape[1] - bx)
            bh = min(sps.ctu_size >> sy, pic.planes[comp].shape[0] - by)
            org = src_planes[comp][by : by + bh, bx : bx + bw]
            rec = pic.planes[comp][by : by + bh, bx : bx + bw]
            return bx, by, bw, bh, org, rec

        def eval_type(comp, t):
            """(d_sse, type_aux, offsets32) for one component and type."""
            bx, by, bw, bh, org, rec = blk(comp)
            base = float(np.sum((org.astype(np.int64) - rec) ** 2))
            if t == 4:
                aux, offs = _derive_bo(org, rec, bd, max_off)
                if not any(offs):
                    return 0.0, 0, None
            else:
                dx, dy = dirs[t]
                offs5 = _derive_eo_offsets(org, rec, dx, dy, max_off)
                if not any(offs5):
                    return 0.0, 0, None
                aux, offs = 0, offs5 + [0] * 27
            tmp = apply_region(comp, bx, by, bw, bh, t, offs, avail)
            sse = float(np.sum((org.astype(np.int64) - tmp) ** 2))
            return sse - base, aux, offs

        newp = SaoParams()
        # luma: best of EO0-3/BO vs off
        best = (0.0, None)
        for t in range(5):
            dsse, aux, offs = eval_type(0, t)
            if offs is None:
                continue
            rate = sum(abs(v) + 1 for v in offs if v) + 8
            cost = dsse + lam_comp[0] * rate
            if cost < best[0]:
                best = (cost, (t, aux, offs))
        if best[1]:
            t, aux, offs = best[1]
            newp.mode[0] = 1
            newp.type_idc[0] = t
            newp.type_aux[0] = aux
            newp.offsets[0] = [int(v) for v in offs]
        # chroma: Cb and Cr share mode and type_idc (CABACReader.sao:212-230)
        if n_comp == 3:
            best = (0.0, None)
            for t in range(5):
                d1, aux1, o1 = eval_type(1, t)
                d2, aux2, o2 = eval_type(2, t)
                if o1 is None and o2 is None:
                    continue
                if o1 is None:
                    d1, aux1, o1 = 0.0, 0, [0] * 32
                if o2 is None:
                    d2, aux2, o2 = 0.0, 0, [0] * 32
                rate = sum(abs(v) + 1 for v in o1 + o2 if v) + 10
                cost = d1 + d2 + lam_comp[1] * rate
                if cost < best[0]:
                    best = (cost, (t, aux1, o1, aux2, o2))
            if best[1]:
                t, aux1, o1, aux2, o2 = best[1]
                for comp, aux, offs in ((1, aux1, o1), (2, aux2, o2)):
                    newp.mode[comp] = 1
                    newp.type_idc[comp] = t
                    newp.type_aux[comp] = aux
                    newp.offsets[comp] = [int(v) for v in offs]
        cand_params.append(newp)
        # merge candidates reuse the neighbour's RESOLVED params
        if avail[0] and resolved[addr - 1] is not None:
            m = SaoParams()
            m.mode = [2, 2, 2]
            m.type_idc = [0, 0, 0]
            m._resolved = resolved[addr - 1]
            cand_params.append(m)
        if avail[2] and resolved[addr - w_ctu] is not None:
            m = SaoParams()
            m.mode = [2, 2, 2]
            m.type_idc = [1, 1, 1]
            m._resolved = resolved[addr - w_ctu]
            cand_params.append(m)
        # evaluate candidates exactly: apply + measure, price with CABAC
        best_cost, best_p, best_res, best_est = None, None, None, None
        for p in cand_params:
            rp = getattr(p, "_resolved", None) or p
            sse = 0.0
            for comp in range(n_comp):
                sx = fmt.scale_x if comp else 0
                sy = fmt.scale_y if comp else 0
                bx, by = x0 >> sx, y0 >> sy
                bw = min(sps.ctu_size >> sx, pic.planes[comp].shape[1] - bx)
                bh = min(sps.ctu_size >> sy, pic.planes[comp].shape[0] - by)
                if bw <= 0 or bh <= 0:
                    continue
                org = src_planes[comp][by : by + bh, bx : bx + bw]
                rec = pic.planes[comp][by : by + bh, bx : bx + bw]
                if rp.mode[comp] == 0:
                    sse += float(np.sum((org.astype(np.int64) - rec) ** 2))
                    continue
                tmp = apply_region(comp, bx, by, bw, bh, rp.type_idc[comp],
                                   rp.offsets[comp], avail)
                sse += float(np.sum((org.astype(np.int64) - tmp) ** 2))
            e = est.copy()
            b0 = e.frac_bits
            SyntaxWriter(dcs, e).sao(rect, p)
            bits = (e.frac_bits - b0) / 32768.0
            cost = sse + lam * bits
            if best_cost is None or cost < best_cost:
                best_cost, best_p, best_est = cost, p, e
        # commit
        if hasattr(best_p, "_resolved"):
            res = copy.deepcopy(best_p._resolved)
            del best_p._resolved
        else:
            res = copy.deepcopy(best_p)
        for p2 in cand_params:
            if hasattr(p2, "_resolved"):
                del p2._resolved
        resolved[addr] = res
        pic.sao_params[addr] = best_p
        est.ctx = best_est.ctx
        est.frac_bits = best_est.frac_bits