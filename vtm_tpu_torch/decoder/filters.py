"""In-loop filter chain of the decoder (DecLib::executeLoopFilters:596).

Counterpart of vtm_tpu/decoder/filters.py.  The stage parameters come from
vtm_tpu's unchanged host functions (build_pic_maps, build_sao_maps) and the
port's build_alf_tables; the chain runs on the decoder's torch device and
its packed output stays there until the picture's first host use.

Not carried over: the filter-capture hook and the DMVR motion-field update,
which only inter decode needs.
"""

from __future__ import annotations

from vtm_tpu.ops import deblock as DB
from vtm_tpu.ops import sao as SAO
from vtm_tpu_torch.ops import alf as ALF
from vtm_tpu_torch.ops import filter_chain as FC


def apply_loop_filters(dec, pic) -> None:
    if not hasattr(pic, "dcs"):
        return
    dcs = pic.dcs
    lmcs = getattr(pic, "lmcs_model", None)
    lmcs_lut = None
    if lmcs is not None and any(sl.lmcs_enabled for sl in pic.slices):
        lmcs_lut = lmcs.inv_lut
    dmaps = None
    if any(not sl.deblocking_disable for sl in pic.slices):
        dmaps = DB.build_pic_maps(dcs, pic)
    sao_maps = None
    if dcs.sps.sao and any(sl.sao_enabled[0] or sl.sao_enabled[1] for sl in pic.slices):
        sao_maps = SAO.build_sao_maps(dcs, pic)
    alf_tables = None
    if dcs.sps.alf and any(sl.alf_enabled[0] or sl.alf_enabled[1] or sl.alf_enabled[2]
                           or sl.ccalf_cb_enabled or sl.ccalf_cr_enabled
                           for sl in pic.slices):
        alf_tables = ALF.build_alf_tables(dcs, pic)
    fmt = dcs.chroma_format
    pic._pending_packed = FC.run_filter_chain(
        pic.planes, lmcs_lut, dmaps, sao_maps, alf_tables,
        dcs.sps.bit_depth, fmt.scale_x, fmt.scale_y, dec.device)
