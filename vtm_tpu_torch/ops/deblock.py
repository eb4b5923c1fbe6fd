"""Picture deblocking of the encoder's reconstruction on a torch device.

Counterpart of vtm_tpu/ops/deblock.py:deblock_picture / _apply_maps
(L318-400).  The sample-independent marking pass (`build_pic_maps`) is
vtm_tpu's, unchanged; each direction's filtering runs through the port's
`deblock_dir` (csrc/deblock.cu on a GPU, the plain version on the CPU) with
the reference's has_l / has_cb / has_cr gating, and the result is written
back in place into `pic.planes` (numpy), which the encoder reads next.
"""

from __future__ import annotations

from vtm_tpu.ops import deblock as DB
from vtm_tpu_torch.ops import deblock_kernel as DK
from vtm_tpu_torch.ops.filter_chain import DMAP_FIELDS, to_device


def deblock_picture(dcs, pic, device) -> None:
    """loopFilterPic over the coding structure: VER edges, then HOR."""
    for edge_dir, maps in zip((DB.EDGE_VER, DB.EDGE_HOR), DB.build_pic_maps(dcs, pic)):
        _apply_maps(dcs, pic, maps, edge_dir, device)


def _apply_maps(dcs, pic, maps, edge_dir, device) -> None:
    """One direction over all components: upload, filter, fetch."""
    bd = dcs.sps.bit_depth
    fmt = dcs.chroma_format
    has_l = bool(maps.l_active.any())
    has_chroma = fmt.num_components > 1
    has_cb = has_chroma and bool(maps.cb_active.any())
    has_cr = has_chroma and bool(maps.cr_active.any())
    if not (has_l or has_cb or has_cr):
        return
    pl = pic.planes[0]
    pcb = pic.planes[1] if has_chroma else pl
    pcr = pic.planes[2] if has_chroma else pl
    y, cb, cr = (to_device(p, device) for p in (pl, pcb, pcr))
    dmaps = [to_device(getattr(maps, f), device) for f in DMAP_FIELDS]
    oy, ocb, ocr = DK.deblock_dir(
        y, cb, cr, *dmaps, bit_depth=bd, hor=edge_dir == DB.EDGE_HOR,
        has_l=has_l, has_cb=has_cb, has_cr=has_cr, sx=fmt.scale_x, sy=fmt.scale_y)
    for on, dst, out in ((has_l, pl, oy), (has_cb, pcb, ocb), (has_cr, pcr, ocr)):
        if on:
            dst[:] = out.cpu().numpy().astype(dst.dtype)
