"""Inter CU reconstruction: MV finalization + motion compensation + residual.

Behavioral equivalent of DecCu::xDeriveCUMV (DecCu.cpp:826),
DecCu::xReconInter:639, xDecodeInterTexture:798 and
InterPrediction::motionCompensation:1437 / xPredInterUni:445 /
xPredInterBi:515 / xPredInterBlk:660 / xWeightedAverage:1354.
"""

from __future__ import annotations

import numpy as np

from vtm_tpu_torch.decoder import cs as D
from vtm_tpu_torch.decoder.cs import Rect
from vtm_tpu_torch.decoder import motion as M
from vtm_tpu_torch.ops import mc as MC

MV_FRAC = 4  # luma fractional bits of the internal MV


def derive_cu_mv(dcs, cu) -> None:
    """DecCu::xDeriveCUMV."""
    if cu.pred_mode == D.MODE_IBC:
        if cu.merge_flag:
            mrg = M.get_ibc_merge_candidates(dcs, cu, cu.merge_idx)
            M.set_merge_info(dcs, cu, mrg, cu.merge_idx)
            cu.imv = 0  # setMergeInfo IBC override (ContextModelling.cpp:348)
        else:
            cands = M.fill_ibc_mvp_cand(dcs, cu)
            mvd = M.change_ibc_prec_amvr_2_internal(cu.mvd[0], cu.imv)
            mv = (cands[cu.mvp_idx[0]][0] + mvd[0], cands[cu.mvp_idx[0]][1] + mvd[1])
            cu.mv[0] = M.mv_clip_periodic(mv)
        M.span_motion_info(dcs, cu)
        return
    if cu.merge_flag:
        if cu.mmvd_flag or cu.mmvd_skip:
            base_idx = cu.mmvd_idx // M.MMVD_MAX_REFINE_NUM
            mrg = M.get_inter_merge_candidates(dcs, cu, base_idx + 1)
            M.set_mmvd_merge_info(dcs, cu, mrg, cu.mmvd_idx)
            M.span_motion_info(dcs, cu)
            return
        if cu.geo_flag:
            cu._geo_mrg = M.get_geo_merge_candidates(dcs, cu)
            M.span_geo_motion_info(dcs, cu, cu._geo_mrg)
            return
        if cu.affine:
            from vtm_tpu_torch.decoder import affine as AF

            ctx = AF.get_affine_merge_cand(dcs, cu, cu.merge_idx)
            i = cu.merge_idx
            cu.interdir = ctx.interdir[i]
            cu.affine_type = ctx.affine_type[i]
            cu.bcw_idx = ctx.bcw[i]
            cu.merge_type = ctx.merge_type[i]
            if cu.merge_type == AF.MRG_TYPE_SUBPU_ATMVP:
                # cu.affine stays true (VTM keeps the flag; MC dispatches on
                # mergeType) — it gates HMVP skip and the deblock P-side cap
                cu.ref_idx = [ctx.ref_idx[i][0], ctx.ref_idx[i][1]]
                sub, pu_w, pu_h = ctx.subpu_mi
                cu._sbtmvp = (sub, pu_w, pu_h)
                AF.span_sbtmvp_motion(dcs, cu, sub, pu_w, pu_h)
                return
            for lst in range(2):
                if dcs.sh.num_ref_idx[lst] > 0:
                    cu.mvp_idx[lst] = 0
                    cu.mvd[lst] = (0, 0)
                    cu.ref_idx[lst] = ctx.ref_idx[i][lst]
                    AF.set_all_affine_mv(dcs, cu, lst, ctx.mv[i][lst][0],
                                         ctx.mv[i][lst][1], ctx.mv[i][lst][2],
                                         clip_cpmvs=False)
            AF.span_affine_motion(dcs, cu)
            return
        mrg = M.get_inter_merge_candidates(dcs, cu, cu.merge_idx)
        M.set_merge_info(dcs, cu, mrg, cu.merge_idx)
        M.span_motion_info(dcs, cu)
        return
    if cu.affine:
        from vtm_tpu_torch.decoder import affine as AF

        for lst in range(2):
            if dcs.sh.num_ref_idx[lst] > 0 and (cu.interdir & (1 << lst)):
                cands = AF.fill_affine_mvp_cand(dcs, cu, lst, cu.ref_idx[lst])
                mvd0 = AF.change_affine_prec_amvr_2_internal(cu.mvd_affi[lst][0], cu.imv)
                mvd1 = AF.change_affine_prec_amvr_2_internal(cu.mvd_affi[lst][1], cu.imv)
                cand = cands[cu.mvp_idx[lst]]
                lt = (cand[0][0] + mvd0[0], cand[0][1] + mvd0[1])
                rt = (cand[1][0] + mvd1[0] + mvd0[0], cand[1][1] + mvd1[1] + mvd0[1])
                lb = (0, 0)
                if cu.affine_type == 1:
                    mvd2 = AF.change_affine_prec_amvr_2_internal(cu.mvd_affi[lst][2], cu.imv)
                    lb = (cand[2][0] + mvd2[0] + mvd0[0], cand[2][1] + mvd2[1] + mvd0[1])
                AF.set_all_affine_mv(dcs, cu, lst, lt, rt, lb, clip_cpmvs=True)
        AF.span_affine_motion(dcs, cu)
        return
    for lst in range(2):
        if (dcs.sh.num_ref_idx[lst] > 0) and (cu.interdir & (1 << lst)):
            cands = M.fill_mvp_cand(dcs, cu, lst, cu.ref_idx[lst])
            mvd = M.change_trans_prec_amvr_2_internal(cu.mvd[lst], cu.imv)
            mv = (cands[cu.mvp_idx[lst]][0] + mvd[0],
                  cands[cu.mvp_idx[lst]][1] + mvd[1])
            cu.mv[lst] = M.mv_clip_periodic(mv)
    M.span_motion_info(dcs, cu)


def _mc_one_list(recon, dcs, cu, lst: int, rnd_res: bool):
    """xPredInterUni → per-component prediction arrays [Y, Cb, Cr]."""
    sh = dcs.sh
    ref_pic = sh.ref_pics[lst][cu.ref_idx[lst]]
    bd = recon.bit_depth
    fmt = dcs.chroma_format
    b = cu.blocks[0]
    mv = M.clip_mv_in_pic(cu.mv[lst], b.x, b.y, dcs)
    use_alt_hpel = cu.imv == M.IMV_HPEL
    preds = []
    for comp in range(fmt.num_components):
        cb = cu.blocks[comp]
        sx = fmt.scale_x if comp else 0
        sy = fmt.scale_y if comp else 0
        shift_h = MV_FRAC + sx
        shift_v = MV_FRAC + sy
        frac_x = mv[0] & ((1 << shift_h) - 1)
        frac_y = mv[1] & ((1 << shift_v) - 1)
        x0 = cb.x + (mv[0] >> shift_h)
        y0 = cb.y + (mv[1] >> shift_v)
        preds.append(
            MC.mc_block(
                ref_pic.planes[comp], x0, y0, cb.w, cb.h, frac_x, frac_y,
                comp == 0, bd, rnd_res, use_alt_hpel, sx, sy,
            )
        )
    return preds


def _wp_apply_uni(dcs, cu, lst, preds, bd):
    """WeightPrediction::addWeightUni (WeightPrediction.cpp:288) on
    intermediate-precision predictions."""
    wps = dcs.sh.wp_scaling[lst][cu.ref_idx[lst]]
    shift_num = max(2, MC.IF_INTERNAL_PREC - bd)
    maxv = (1 << bd) - 1
    scale = 1 << (bd - 8)
    out = []
    for comp, p in enumerate(preds):
        if p is None:
            out.append(None)
            continue
        wp = wps[comp]
        w = wp["w"]
        off = wp["o"] * scale
        shift = wp["denom"] + shift_num
        rnd = 1 << (shift - 1) if shift > 0 else 0
        v = ((w * (p + MC.IF_INTERNAL_OFFS) + rnd) >> shift) + off
        out.append(np.clip(v, 0, maxv))
    return out


def _wp_apply_bi(dcs, cu, p0s, p1s, bd):
    """WeightPrediction::addWeightBi (weightBidir, WeightPrediction.h:46)."""
    wp0s = dcs.sh.wp_scaling[0][cu.ref_idx[0]]
    wp1s = dcs.sh.wp_scaling[1][cu.ref_idx[1]]
    shift_num = max(2, MC.IF_INTERNAL_PREC - bd)
    maxv = (1 << bd) - 1
    scale = 1 << (bd - 8)
    out = []
    for comp, (p0, p1) in enumerate(zip(p0s, p1s)):
        if p0 is None:
            out.append(None)
            continue
        wp0, wp1 = wp0s[comp], wp1s[comp]
        o0 = wp0["o"] * scale
        o1 = wp1["o"] * scale
        shift = wp0["denom"] + 1 + shift_num
        rnd = 1 << (shift - 1) if shift > 0 else 0
        v = (
            wp0["w"] * (p0 + MC.IF_INTERNAL_OFFS)
            + wp1["w"] * (p1 + MC.IF_INTERNAL_OFFS)
            + rnd + ((o0 + o1) << (shift - 1))
        ) >> shift
        out.append(np.clip(v, 0, maxv))
    return out


def _plan_one_list(batch, dcs, cu, lst: int, rnd_res: bool, blocks=None,
                   mv=None, ref_idx=None, use_alt_hpel=None):
    """Batched twin of _mc_one_list: registers per-component tile jobs on
    the McBatch and returns handles (resolved after batch.execute())."""
    sh = dcs.sh
    if blocks is None:
        blocks = cu.blocks
    if mv is None:
        mv = cu.mv[lst]
    if ref_idx is None:
        ref_idx = cu.ref_idx[lst]
    if use_alt_hpel is None:
        use_alt_hpel = cu.imv == M.IMV_HPEL
    ref_pic = sh.ref_pics[lst][ref_idx]
    dev = getattr(ref_pic, "device_planes", None)
    planes = dev if dev is not None else ref_pic.planes
    bd = dcs.sps.bit_depth
    fmt = dcs.chroma_format
    b = blocks[0]
    mv = M.clip_mv_in_pic(mv, b.x, b.y, dcs)
    handles = []
    for comp in range(fmt.num_components):
        cb = blocks[comp]
        sx = fmt.scale_x if comp else 0
        sy = fmt.scale_y if comp else 0
        shift_h = MV_FRAC + sx
        shift_v = MV_FRAC + sy
        frac_x = mv[0] & ((1 << shift_h) - 1)
        frac_y = mv[1] & ((1 << shift_v) - 1)
        x0 = cb.x + (mv[0] >> shift_h)
        y0 = cb.y + (mv[1] >> shift_v)
        if comp == 0:
            hor_h = cb.h if frac_y == 0 else cb.h + MC.NTAPS_LUMA - 1
            cf_h = MC.luma_coeffs(frac_x, cb.w, hor_h, use_alt_hpel, True)
            cf_v = MC.luma_coeffs(frac_y, cb.w, cb.h, use_alt_hpel, False)
        else:
            cf_h = MC._CHROMA[frac_x << (1 - sx)]
            cf_v = MC._CHROMA[frac_y << (1 - sy)]
        handles.append(
            batch.add_block(planes[comp], x0, y0, cb.w, cb.h,
                            cf_h, cf_v, frac_y != 0, rnd_res, comp == 0)
        )
    return handles


def plan_cu_mc(batch, recon, cu):
    """Plan the inter prediction of one CU on the slice-level MC batch.

    Returns a finalize closure to be invoked (in coding order) after
    batch.execute(); the closure returns [Y, Cb, Cr] predictions.
    Sub-PU / sample-adaptive modes (DMVR, BDOF, affine, SbTMVP) currently
    fall back to the scalar path inside the closure."""
    from vtm_tpu_torch.common.types import SliceType

    dcs = recon.cs
    bd = recon.bit_depth
    fmt = dcs.chroma_format
    if cu.pred_mode == D.MODE_IBC:
        return lambda: ibc_block_copy(recon, dcs, cu)
    if cu.geo_flag:
        geo = cu._geo_mrg
        parts = []
        for cand in cu.geo_merge_idx:
            interdir = geo.interdir[cand]
            lst = 0 if interdir == 1 else 1
            parts.append(
                _plan_one_list(batch, dcs, cu, lst, rnd_res=False,
                               mv=geo.mv[cand][lst], ref_idx=geo.ref_idx[cand][lst],
                               use_alt_hpel=False)
            )

        def fin_geo():
            out = []
            b = cu.blocks[0]
            for comp in range(fmt.num_components):
                sx = fmt.scale_x if comp else 0
                sy = fmt.scale_y if comp else 0
                wts = MC.geo_weight_block(cu.geo_split_dir, b.w, b.h, sx, sy,
                                          b.w >> sx, b.h >> sy)
                p0 = batch.block_result(parts[0][comp])
                p1 = batch.block_result(parts[1][comp])
                out.append(MC.geo_blend(p0, p1, wts, bd))
            return out

        return fin_geo
    if getattr(cu, "_sbtmvp", None) is not None:
        return lambda: _sbtmvp_mc(recon, dcs, cu)
    if cu.affine:
        return lambda: _affine_mc(recon, dcs, cu)
    pps = dcs.pps
    sh = dcs.sh
    wp_slice = (
        (sh.slice_type == SliceType.P and pps.weighted_pred)
        or (sh.is_b and pps.weighted_bipred)
    )
    if cu.interdir == 3:
        if not cu.ciip_flag:
            bdof_ok = (
                dcs.sps.bdof and not dcs.ph.dis_bdof and _bdof_condition(dcs, cu)
            )
            if dcs.sps.dmvr and not dcs.ph.dis_dmvr and _dmvr_condition(dcs, cu):
                return ("dmvr", bdof_ok)
            if bdof_ok:
                return ("bdof",)
        h0 = _plan_one_list(batch, dcs, cu, 0, rnd_res=False)
        h1 = _plan_one_list(batch, dcs, cu, 1, rnd_res=False)

        def fin_bi():
            p0 = [batch.block_result(h) for h in h0]
            p1 = [batch.block_result(h) for h in h1]
            if (
                pps.weighted_bipred and sh.is_b and not cu.geo_flag
                and cu.bcw_idx == M.BCW_DEFAULT
            ):
                return _wp_apply_bi(dcs, cu, p0, p1, bd)
            out = []
            for comp in range(fmt.num_components):
                if cu.bcw_idx != M.BCW_DEFAULT and not cu.ciip_flag:
                    w1 = _BCW_WEIGHTS[cu.bcw_idx]
                    out.append(MC.bcw_average(p0[comp], p1[comp], bd, 8 - w1, w1))
                else:
                    out.append(MC.bi_average(p0[comp], p1[comp], bd))
            return out

        return fin_bi
    lst = 0 if cu.interdir == 1 else 1
    if wp_slice:
        hs = _plan_one_list(batch, dcs, cu, lst, rnd_res=False)

        def fin_wp():
            preds = [batch.block_result(h) for h in hs]
            return _wp_apply_uni(dcs, cu, lst, preds, bd)

        return fin_wp
    hs = _plan_one_list(batch, dcs, cu, lst, rnd_res=True)
    return lambda: [batch.block_result(h) for h in hs]


def motion_compensation(recon, dcs, cu):
    """InterPrediction::motionCompensation → [Y, Cb, Cr] final samples."""
    from vtm_tpu_torch.common.types import SliceType

    bd = recon.bit_depth
    fmt = dcs.chroma_format
    if getattr(cu, "_sbtmvp", None) is not None:
        return _sbtmvp_mc(recon, dcs, cu)
    if cu.affine:
        return _affine_mc(recon, dcs, cu)
    pps = dcs.pps
    sh = dcs.sh
    wp_slice = (
        (sh.slice_type == SliceType.P and pps.weighted_pred)
        or (sh.is_b and pps.weighted_bipred)
    )
    if cu.interdir == 3:
        if not cu.ciip_flag:
            from vtm_tpu_torch.decoder import refine

            bdof_ok = (
                dcs.sps.bdof and not dcs.ph.dis_bdof and _bdof_condition(dcs, cu)
            )
            if dcs.sps.dmvr and not dcs.ph.dis_dmvr and _dmvr_condition(dcs, cu):
                preds, mvd_sub, sdx, sdy = refine.dmvr_motion_compensation(
                    recon, dcs, cu, bdof_ok
                )
                cu._dmvr_mvd = (mvd_sub, sdx, sdy)
                return preds
            if bdof_ok:
                return refine.bdof_motion_compensation(recon, dcs, cu)
        p0 = _mc_one_list(recon, dcs, cu, 0, rnd_res=False)
        p1 = _mc_one_list(recon, dcs, cu, 1, rnd_res=False)
        # explicit weighted bi-prediction (InterPrediction.cpp:631)
        if (
            pps.weighted_bipred and sh.is_b and not cu.geo_flag
            and cu.bcw_idx == M.BCW_DEFAULT
        ):
            return _wp_apply_bi(dcs, cu, p0, p1, bd)
        out = []
        for comp in range(fmt.num_components):
            if cu.bcw_idx != M.BCW_DEFAULT and not cu.ciip_flag:
                w1 = _BCW_WEIGHTS[cu.bcw_idx]
                out.append(MC.bcw_average(p0[comp], p1[comp], bd, 8 - w1, w1))
            else:
                out.append(MC.bi_average(p0[comp], p1[comp], bd))
        return out
    lst = 0 if cu.interdir == 1 else 1
    if wp_slice:
        # uni WP path (InterPrediction.cpp:1477-1485)
        preds = _mc_one_list(recon, dcs, cu, lst, rnd_res=False)
        return _wp_apply_uni(dcs, cu, lst, preds, bd)
    return _mc_one_list(recon, dcs, cu, lst, rnd_res=True)


def _affine_mc(recon, dcs, cu):
    """Affine MC over both lists with PROF + averaging."""
    from vtm_tpu_torch.decoder import affine as AF

    bd = recon.bit_depth
    fmt = dcs.chroma_format
    bi = cu.interdir == 3
    per_list = []
    for lst in range(2):
        if not (cu.interdir & (1 << lst)):
            per_list.append(None)
            continue
        stored = {}
        comps = []
        for comp in range(fmt.num_components):
            comps.append(
                AF.affine_mc_component(recon, dcs, cu, lst, comp,
                                       rnd_res=not bi, stored_mv=stored)
            )
        per_list.append(comps)
    if not bi:
        return per_list[0] if per_list[0] is not None else per_list[1]
    out = []
    for comp in range(fmt.num_components):
        p0 = per_list[0][comp]
        p1 = per_list[1][comp]
        if cu.bcw_idx != M.BCW_DEFAULT:
            w1 = _BCW_WEIGHTS[cu.bcw_idx]
            out.append(MC.bcw_average(p0, p1, bd, 8 - w1, w1))
        else:
            out.append(MC.bi_average(p0, p1, bd))
    return out


def _sbtmvp_mc(recon, dcs, cu):
    """xSubPuMC (InterPrediction.cpp:275): per-subblock translational MC with
    same-motion run joining."""
    sub, pu_w, pu_h = cu._sbtmvp
    bd = recon.bit_depth
    fmt = dcs.chroma_format
    b = cu.blocks[0]
    preds = [np.zeros((b.h >> (fmt.scale_y if c else 0),
                       b.w >> (fmt.scale_x if c else 0)), dtype=np.int64)
             for c in range(fmt.num_components)]
    ver_mc = b.h > b.w
    n_rows = len(sub)
    n_cols = len(sub[0])
    saved = (cu.mv, cu.ref_idx, cu.interdir)

    def run_mc(x, y, dx, dy, d, mv, ri):
        cu.mv = [mv[0], mv[1]]
        cu.ref_idx = [ri[0], ri[1]]
        cu.interdir = d
        sub_blocks = [Rect(x, y, dx, dy)]
        # temporary blocks for MC position math
        old_blocks = cu.blocks
        cu.blocks = [
            Rect(x, y, dx, dy),
            Rect(x >> fmt.scale_x, y >> fmt.scale_y,
                 dx >> fmt.scale_x, dy >> fmt.scale_y)
            if fmt.num_components > 1 else None,
            Rect(x >> fmt.scale_x, y >> fmt.scale_y,
                 dx >> fmt.scale_x, dy >> fmt.scale_y)
            if fmt.num_components > 1 else None,
        ]
        if d == 3:
            p0 = _mc_one_list(recon, dcs, cu, 0, rnd_res=False)
            p1 = _mc_one_list(recon, dcs, cu, 1, rnd_res=False)
            res = [MC.bi_average(p0[c], p1[c], bd)
                   for c in range(fmt.num_components)]
        else:
            lst = 0 if d == 1 else 1
            res = _mc_one_list(recon, dcs, cu, lst, rnd_res=True)
        cu.blocks = old_blocks
        for c in range(fmt.num_components):
            sx = fmt.scale_x if c else 0
            sy = fmt.scale_y if c else 0
            preds[c][(y - b.y) >> sy : (y - b.y + dy) >> sy,
                     (x - b.x) >> sx : (x - b.x + dx) >> sx] = res[c]

    if not ver_mc:
        for sy in range(n_rows):
            sx = 0
            while sx < n_cols:
                d, mv, ri = sub[sy][sx]
                length = 1
                while sx + length < n_cols and sub[sy][sx + length] == (d, mv, ri):
                    length += 1
                run_mc(b.x + sx * pu_w, b.y + sy * pu_h,
                       length * pu_w, pu_h, d, mv, ri)
                sx += length
    else:
        for sx in range(n_cols):
            sy = 0
            while sy < n_rows:
                d, mv, ri = sub[sy][sx]
                length = 1
                while sy + length < n_rows and sub[sy + length][sx] == (d, mv, ri):
                    length += 1
                run_mc(b.x + sx * pu_w, b.y + sy * pu_h,
                       pu_w, length * pu_h, d, mv, ri)
                sy += length
    cu.mv, cu.ref_idx, cu.interdir = saved
    return preds


def _ciip_intra_pred(recon, cu, comp: int) -> np.ndarray:
    """Planar intra prediction for CIIP via the shared intra path
    (IntraPrediction::geneIntrainterPred, IntraPrediction.cpp:736)."""
    from vtm_tpu_torch.ops import intra as I

    b = cu.blocks[comp]
    is_luma = comp == 0
    p = I.IntraParams(D.PLANAR_IDX, b.w, b.h,
                      cu.blocks[comp].w, cu.blocks[comp].h, is_luma, 0,
                      False, False)
    # use the CU's first TU for ref-sample fill (TU == CU for inter)
    top, left = recon.fill_reference_samples(b, cu, comp, 0)
    if p.ref_filter_flag:
        ftop, fleft = I.filter_reference_samples(top, left, b.w * 2, b.h * 2, 0)
    else:
        ftop, fleft = top, left
    pred = I.pred_planar(ftop, fleft, b.w, b.h)
    if p.apply_pdpc:
        pred = I.pdpc_planar_dc(pred, ftop, fleft)
    return pred


def ciip_blend(recon, dcs, cu, preds) -> list:
    """geneWeightedPred (IntraPrediction.cpp:682): blend the inter prediction
    with planar intra using neighbour-intra-dependent weights."""
    b = cu.blocks[0]
    n0 = M._get_pu_restricted(dcs, cu, b.x - 1, b.y + b.h - 1)
    n1 = M._get_pu_restricted(dcs, cu, b.x + b.w - 1, b.y - 1)
    i0 = n0 is not None and n0.pred_mode == D.MODE_INTRA
    i1 = n1 is not None and n1.pred_mode == D.MODE_INTRA
    if i0 and i1:
        w_intra, w_merge = 3, 1
    elif not i0 and not i1:
        w_intra, w_merge = 1, 3
    else:
        w_intra, w_merge = 2, 2
    fmt = dcs.chroma_format
    maxv = (1 << recon.bit_depth) - 1
    lmcs = getattr(dcs, "lmcs_model", None)
    lmcs_on = lmcs is not None and dcs.sh.lmcs_enabled
    out = []
    for comp in range(fmt.num_components):
        p = preds[comp]
        if comp == 0 and lmcs_on:
            p = lmcs.fwd_lut[np.clip(p, 0, maxv)]
        if comp > 0 and cu.blocks[comp].w <= 2:
            out.append(p)
            continue
        intra = _ciip_intra_pred(recon, cu, comp)
        out.append((w_merge * p + w_intra * intra + 2) >> 2)
    return out


_BCW_WEIGHTS = [-2, 3, 4, 5, 10]  # g_BcwWeights (CommonDef)


def _dmvr_condition(dcs, cu) -> bool:
    """PU::checkDMVRCondition (UnitTools.cpp:1330)."""
    sh = dcs.sh
    b = cu.blocks[0]
    if not (cu.merge_flag and cu.regular_merge_flag):
        return False
    if cu.mmvd_flag or cu.mmvd_skip or cu.ciip_flag or cu.affine:
        return False
    if cu.interdir != 3 or cu.bcw_idx != M.BCW_DEFAULT:
        return False
    poc = sh.poc
    poc0 = sh.ref_pocs[0][cu.ref_idx[0]]
    poc1 = sh.ref_pocs[1][cu.ref_idx[1]]
    if (poc - poc0) != (poc1 - poc):
        return False
    if sh.ref_longterm[0][cu.ref_idx[0]] or sh.ref_longterm[1][cu.ref_idx[1]]:
        return False
    if sh.wp_present(cu.ref_idx):
        return False
    return b.h >= 8 and b.w >= 8 and (b.w * b.h) >= 128


def _bdof_condition(dcs, cu) -> bool:
    """BDOF applicability inside xPredInterBi (InterPrediction.cpp:526)."""
    sh = dcs.sh
    b = cu.blocks[0]
    if cu.affine or cu.smvd_mode or cu.ciip_flag:
        return False
    if cu.bcw_idx != M.BCW_DEFAULT and dcs.sps.bcw:
        return False
    if sh.wp_present(cu.ref_idx):
        return False
    # isBiPredFromDifferentDirEqDistPoc
    poc = sh.poc
    poc0 = sh.ref_pocs[0][cu.ref_idx[0]]
    poc1 = sh.ref_pocs[1][cu.ref_idx[1]]
    if sh.ref_longterm[0][cu.ref_idx[0]] or sh.ref_longterm[1][cu.ref_idx[1]]:
        return False
    if (poc - poc0) != (poc1 - poc):
        return False
    return b.h >= 8 and b.w >= 8 and (b.h * b.w) >= 128


def _geo_motion_compensation(recon, dcs, cu):
    """InterPrediction::motionCompensationGeo + weightedGeoBlk."""
    geo = cu._geo_mrg
    bd = recon.bit_depth
    fmt = dcs.chroma_format
    parts = []
    saved = (cu.mv, cu.ref_idx, cu.interdir, cu.imv)
    for cand in cu.geo_merge_idx:
        cu.mv = [geo.mv[cand][0], geo.mv[cand][1]]
        cu.ref_idx = [geo.ref_idx[cand][0], geo.ref_idx[cand][1]]
        cu.interdir = geo.interdir[cand]
        cu.imv = 0
        lst = 0 if cu.interdir == 1 else 1
        parts.append(_mc_one_list(recon, dcs, cu, lst, rnd_res=False))
    cu.mv, cu.ref_idx, cu.interdir, cu.imv = saved
    out = []
    b = cu.blocks[0]
    for comp in range(fmt.num_components):
        sx = fmt.scale_x if comp else 0
        sy = fmt.scale_y if comp else 0
        wts = MC.geo_weight_block(cu.geo_split_dir, b.w, b.h, sx, sy,
                                  b.w >> sx, b.h >> sy)
        out.append(MC.geo_blend(parts[0][comp], parts[1][comp], wts, bd))
    return out


def ibc_block_copy(recon, dcs, cu):
    """InterPrediction::xIntraBlockCopy (InterPrediction.cpp:2231): copy
    from the wrap-addressed IBC virtual buffer."""
    fmt = dcs.chroma_format
    ctu = dcs.sps.ctu_size
    log2ctu = ctu.bit_length() - 1
    bufw = (256 * 128) // ctu
    bvx = M._change_prec_comp(cu.mv[0][0], -MV_FRAC)
    bvy = M._change_prec_comp(cu.mv[0][1], -MV_FRAC)
    preds = []
    for comp in range(fmt.num_components):
        cb = cu.blocks[comp]
        if cb is None:
            preds.append(None)
            continue
        sx = fmt.scale_x if comp else 0
        sy = fmt.scale_y if comp else 0
        bw = bufw >> sx
        if comp == 0:
            refx, refy = cb.x + bvx, cb.y + bvy
        else:
            refx = cb.x + (bvx >> sx)
            refy = cb.y + (bvy >> sy)
        refx &= bw - 1
        refy &= (1 << (log2ctu - sy)) - 1
        buf = recon.ibc_buf[comp]
        if refx + cb.w <= bw:
            pred = buf[refy : refy + cb.h, refx : refx + cb.w].copy()
        else:
            w0 = bw - refx
            pred = np.concatenate(
                [buf[refy : refy + cb.h, refx:bw],
                 buf[refy : refy + cb.h, 0 : cb.w - w0]], axis=1
            )
        preds.append(pred)
    return preds


def recon_inter_cu(recon, cu, fin=None) -> None:
    """DecCu::xReconInter + xDecodeInterTexture.

    `fin` is the finalize closure produced by plan_cu_mc (batched path);
    when None, predictions are computed inline (scalar path)."""
    dcs = recon.cs
    if fin is not None:
        preds = fin()
        if cu.ciip_flag and cu.pred_mode != D.MODE_IBC and not cu.geo_flag:
            preds = ciip_blend(recon, dcs, cu, preds)
    elif cu.pred_mode == D.MODE_IBC:
        preds = ibc_block_copy(recon, dcs, cu)
    elif cu.geo_flag:
        preds = _geo_motion_compensation(recon, dcs, cu)
    else:
        preds = motion_compensation(recon, dcs, cu)
        if cu.ciip_flag:
            preds = ciip_blend(recon, dcs, cu, preds)
    bd = recon.bit_depth
    maxv = (1 << bd) - 1
    lmcs = getattr(dcs, "lmcs_model", None)
    lmcs_on = (lmcs is not None and dcs.sh.lmcs_enabled
               and cu.pred_mode != D.MODE_IBC)
    fmt = dcs.chroma_format
    if not cu.root_cbf:
        for comp in range(fmt.num_components):
            b = cu.blocks[comp]
            if b is None:
                continue
            p = preds[comp]
            if comp == 0 and lmcs_on and not cu.ciip_flag:
                p = lmcs.fwd_lut[np.clip(p, 0, maxv)]
            recon.planes[comp][b.y : b.y1, b.x : b.x1] = np.clip(p, 0, maxv).astype(
                np.int32
            )
            recon.set_decomp(comp, b)
            if comp == 0:
                dcs.qp_map_l[b.y >> 2 : b.y1 >> 2, b.x >> 2 : b.x1 >> 2] = cu.qp
        return
    if cu.color_transform:
        raise NotImplementedError("ACT inter")
    # forward-map the luma prediction into the LMCS domain before adding resi
    for comp in range(fmt.num_components):
        for tu in cu.tus:
            b = tu.blocks[comp]
            if b is None:
                continue
            resi = recon.inv_transform(tu, comp)
            resi = recon._maybe_scale_chroma_resi(tu, comp, resi)
            cb = cu.blocks[comp]
            p = preds[comp][b.y - cb.y : b.y1 - cb.y, b.x - cb.x : b.x1 - cb.x]
            if comp == 0 and lmcs_on and not cu.ciip_flag:
                p = lmcs.fwd_lut[np.clip(p, 0, maxv)]
            rec = np.clip(p + resi, 0, maxv).astype(np.int32)
            recon.planes[comp][b.y : b.y1, b.x : b.x1] = rec
            recon.set_decomp(comp, b)
            if comp == 0:
                dcs.qp_map_l[b.y >> 2 : b.y1 >> 2, b.x >> 2 : b.x1 >> 2] = cu.qp
