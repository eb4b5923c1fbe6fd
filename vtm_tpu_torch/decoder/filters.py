"""In-loop filter chain for the decoder (DecLib::executeLoopFilters:596).

Order: LMCS inverse luma mapping → deblocking → SAO → ALF / CC-ALF.
The stage parameters are built on the host from the per-picture state of
slice decode; the chain runs on the decoder's torch device
(ops/filter_chain.py) and its packed output stays there until the
picture's first host use.  After the chain, DMVR-refined MVs go into the
motion field for the TMVP of later pictures.  Under torch.profiler the maps
are the spans `maps.deblock`, `maps.sao` and `maps.alf`, the motion
`finish.motion` (trace.py).
"""

from __future__ import annotations

from vtm_tpu_torch import trace
from vtm_tpu_torch.decoder import motion as M
from vtm_tpu_torch.ops import alf as ALF
from vtm_tpu_torch.ops import deblock as DB
from vtm_tpu_torch.ops import filter_chain as FC
from vtm_tpu_torch.ops import sao as SAO


def apply_loop_filters(dec, pic) -> None:
    if not hasattr(pic, "dcs"):
        return
    dcs = pic.dcs
    # all filter parameters are sample-independent: build every stage's
    # maps first, then run LMCS→deblock→SAO→ALF on the device
    lmcs = getattr(pic, "lmcs_model", None)
    lmcs_lut = None
    if lmcs is not None and any(sl.lmcs_enabled for sl in pic.slices):
        lmcs_lut = lmcs.inv_lut
    dmaps = None
    if any(not sl.deblocking_disable for sl in pic.slices):
        with trace.span("maps.deblock"):
            dmaps = DB.build_pic_maps(dcs, pic)
    sao_maps = None
    if dcs.sps.sao and any(sl.sao_enabled[0] or sl.sao_enabled[1] for sl in pic.slices):
        with trace.span("maps.sao"):
            sao_maps = SAO.build_sao_maps(dcs, pic)
    alf_tables = None
    if dcs.sps.alf and any(sl.alf_enabled[0] or sl.alf_enabled[1] or sl.alf_enabled[2]
                           or sl.ccalf_cb_enabled or sl.ccalf_cr_enabled
                           for sl in pic.slices):
        with trace.span("maps.alf"):
            alf_tables = ALF.build_alf_tables(dcs, pic)
    fmt = dcs.chroma_format
    pic._pending_packed = FC.run_filter_chain(
        pic.planes, lmcs_lut, dmaps, sao_maps, alf_tables,
        dcs.sps.bit_depth, fmt.scale_x, fmt.scale_y, dec.device)
    if hasattr(dcs, "mf_mv"):
        with trace.span("finish.motion"):
            store_refined_motion(dcs)


def store_refined_motion(dcs) -> None:
    """DMVR-refined MVs into the 4x4 motion field for TMVP
    (DecLib::executeLoopFilters -> setRefinedMotionField, DecLib.cpp:629)."""
    for cu in dcs.cus:
        mvd_info = getattr(cu, "_dmvr_mvd", None)
        if mvd_info is None:
            continue
        mvd_sub, sdx, sdy = mvd_info
        b = cu.blocks[0]
        for (sy, sx), mvd in mvd_sub.items():
            y0 = (b.y + sy * sdy) >> 2
            x0 = (b.x + sx * sdx) >> 2
            ys = slice(y0, y0 + (sdy >> 2))
            xs = slice(x0, x0 + (sdx >> 2))
            mv0 = M.clip_storage((cu.mv[0][0] + mvd[0], cu.mv[0][1] + mvd[1]))
            mv1 = M.clip_storage((cu.mv[1][0] - mvd[0], cu.mv[1][1] - mvd[1]))
            dcs.mf_mv[ys, xs, 0, 0] = mv0[0]
            dcs.mf_mv[ys, xs, 0, 1] = mv0[1]
            dcs.mf_mv[ys, xs, 1, 0] = mv1[0]
            dcs.mf_mv[ys, xs, 1, 1] = mv1[1]
