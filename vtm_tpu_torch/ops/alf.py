"""Host-side ALF table assembly for the port's alf_all, and the encoder's
picture ALF.

Fork of `build_alf_tables` of vtm_tpu/ops/alf.py: the same tables, with the
virtual-boundary row helpers taken from the port's alf_kernel (the
reference's module imports jax).  Everything else of the reference ALF
(coefficient reconstruction, fixed filter sets, transpose tables) is
imported unchanged.  `alf_picture` is the counterpart of the reference's.
"""

from __future__ import annotations

import numpy as np

from vtm_tpu.ops.alf import (
    MAX_NUM_ALF_CLASSES,
    NUM_FIXED_FILTER_SETS,
    _TR5,
    _TR7,
    fixed_filter_sets,
    reconstruct_chroma_coeffs,
    reconstruct_luma_coeffs,
)
from vtm_tpu_torch.ops import alf_kernel as K
from vtm_tpu_torch.ops import edge_pad
from vtm_tpu_torch.ops.filter_chain import to_device


def build_alf_tables(dcs, pic):
    """Sample-independent ALF tables of one picture: the alf_all argument
    tuple + flags, or None if ALF is fully off."""
    sps = dcs.sps
    bit_depth = sps.bit_depth
    fmt = dcs.chroma_format
    ctu = sps.ctu_size
    vb_luma_pos = ctu - 4
    vb_chroma_ctu = ctu >> (1 if fmt.value == 1 else 0)
    vb_chroma_pos = vb_chroma_ctu - 2
    fixed_sets, clip_default = fixed_filter_sets(bit_depth)
    aps_luma_cache = {}
    chroma_cache = {}
    n_comp = fmt.num_components
    w_ctu = dcs.pic_w_ctu
    n_ctu = w_ctu * dcs.pic_h_ctu
    h, w = dcs.pic_h, dcs.pic_w
    sxc, syc = fmt.scale_x, fmt.scale_y
    hc, wc = h >> syc, w >> sxc

    # ---- per-CTU filter tables (zeros = identity) ----
    any_luma = False
    ctb_coeff = np.zeros((n_ctu, MAX_NUM_ALF_CLASSES, 13), dtype=np.int32)
    ctb_clip = np.zeros_like(ctb_coeff)
    chroma_coeff = np.zeros((n_comp, n_ctu, 7), dtype=np.int32)
    chroma_clip = np.zeros_like(chroma_coeff)
    cc_coeff = np.zeros((n_comp, n_ctu, 7), dtype=np.int32)
    any_chroma = [False] * n_comp
    any_cc = [False] * n_comp
    for addr in range(n_ctu):
        sl_idx = int(dcs.slice_idx_of_ctu[addr])
        sh = dcs._slice_headers[sl_idx]
        if pic.alf_ctb_flag[0][addr] and sh.alf_enabled[0]:
            any_luma = True
            fset = int(pic.alf_ctb_filter_index[addr])
            if fset >= NUM_FIXED_FILTER_SETS:
                aps_id = sh.alf_aps_ids[fset - NUM_FIXED_FILTER_SETS]
                if aps_id not in aps_luma_cache:
                    aps = dcs.aps_map[(0, aps_id)]
                    aps_luma_cache[aps_id] = reconstruct_luma_coeffs(aps.alf, bit_depth)
                coeffs, clips = aps_luma_cache[aps_id]
            else:
                coeffs, clips = fixed_sets[fset], clip_default
            ctb_coeff[addr] = coeffs
            ctb_clip[addr] = clips
        for comp in (1, 2):
            if comp >= n_comp:
                continue
            if pic.alf_ctb_flag[comp][addr] and sh.alf_enabled[comp]:
                aps_id = sh.alf_aps_id_chroma
                alt = int(pic.alf_ctb_alt[comp][addr])
                key = (aps_id, alt)
                if key not in chroma_cache:
                    aps = dcs.aps_map[(0, aps_id)]
                    chroma_cache[key] = reconstruct_chroma_coeffs(aps.alf, alt, bit_depth)
                ccoef, cclip = chroma_cache[key]
                chroma_coeff[comp][addr] = ccoef
                chroma_clip[comp][addr] = cclip
                any_chroma[comp] = True
            cc_enabled = sh.ccalf_cb_enabled if comp == 1 else sh.ccalf_cr_enabled
            if cc_enabled:
                idc = int(pic.ccalf_control[comp - 1][addr])
                if idc:
                    aps_id = sh.ccalf_cb_aps_id if comp == 1 else sh.ccalf_cr_aps_id
                    aps = dcs.aps_map[(0, aps_id)]
                    # APS rows carry CCALF_NUM_COEFF(8) slots; 7 signalled
                    cc_coeff[comp][addr] = \
                        aps.alf.ccalf_coeff[comp - 1][idc - 1][:7]
                    any_cc[comp] = True

    # ---- host-side tables for the alf_all call ----
    perm = np.array([_TR7[t][:12] for t in range(4)], dtype=np.int32)
    cperm = (ctb_coeff[:, :, perm] if any_luma
             else np.zeros((1, 1, 4, 12), dtype=np.int32))
    lperm = (ctb_clip[:, :, perm] if any_luma
             else np.zeros((1, 1, 4, 12), dtype=np.int32))
    h4, w4 = h // 4, w // 4
    by, bx = np.mgrid[0:h4, 0:w4]
    ctu_of = ((by * 4 // ctu) * w_ctu + (bx * 4 // ctu)).astype(np.int32)
    l_orows, l_near = K.vb_row_offsets(h, ctu, vb_luma_pos, True)
    y_i, yd_i, yu_i, yu2_i = K.classify_row_indices(h, ctu, vb_luma_pos)
    drop_f, drop_l, mult = K.classify_block_rows(h, ctu, vb_luma_pos)

    perm5 = np.array(_TR5[0][:6], dtype=np.int32)
    hc4, wc4 = max(hc // 4, 1), max(wc // 4, 1)
    cby, cbx = np.mgrid[0:hc4, 0:wc4]
    ctu_of_c = ((cby * 4) << syc) // ctu * w_ctu + ((cbx * 4) << sxc) // ctu
    c_orows, c_near = K.vb_row_offsets(max(hc, 1), vb_chroma_ctu,
                                       vb_chroma_pos, False)
    cc_orows, cc_skip = K.ccalf_row_offsets(max(hc, 1), syc, ctu, vb_luma_pos)
    zero6 = np.zeros((hc4, wc4, 6), dtype=np.int32)
    zero7 = np.zeros((hc4, wc4, 7), dtype=np.int32)

    def cmaps(comp):
        if comp >= n_comp or not any_chroma[comp]:
            return zero6, zero6
        return (chroma_coeff[comp][:, perm5][ctu_of_c],
                chroma_clip[comp][:, perm5][ctu_of_c])

    cb_coef, cb_clip = cmaps(1)
    cr_coef, cr_clip = cmaps(2)
    cc1 = cc_coeff[1][ctu_of_c] if n_comp > 1 and any_cc[1] else zero7
    cc2 = cc_coeff[2][ctu_of_c] if n_comp > 2 and any_cc[2] else zero7

    has_cb = n_comp > 1 and any_chroma[1]
    has_cr = n_comp > 2 and any_chroma[2]
    has_cc1 = n_comp > 1 and any_cc[1]
    has_cc2 = n_comp > 2 and any_cc[2]
    if not (any_luma or has_cb or has_cr or has_cc1 or has_cc2):
        return None
    return dict(
        args=(cperm.astype(np.int32), lperm.astype(np.int32), ctu_of,
              l_orows, l_near, y_i, yd_i, yu_i, yu2_i, drop_f, drop_l, mult,
              cb_coef, cb_clip, cr_coef, cr_clip, c_orows, c_near,
              cc1, cc2, cc_orows, cc_skip),
        bit_depth=bit_depth, sx=sxc, sy=syc, n_comp=n_comp,
        has_l=any_luma, has_cb=has_cb, has_cr=has_cr,
        has_cc1=has_cc1, has_cc2=has_cc2)


def alf_picture(dcs, pic, device) -> None:
    """ALFProcess over the picture on `device`: counterpart of
    vtm_tpu/ops/alf.py:alf_picture (L303-333), the port's build_alf_tables
    and alf_all (csrc/alf.cu on a GPU, the plain versions on the CPU), the
    filtered planes written back in place into `pic.planes`."""
    t = build_alf_tables(dcs, pic)
    if t is None:
        return
    n_comp = t["n_comp"]
    y = to_device(pic.planes[0], device)
    y_pad = edge_pad(y, K.PAD, K.PAD)
    cb = to_device(pic.planes[1], device) if n_comp > 1 else y_pad
    cr = to_device(pic.planes[2], device) if n_comp > 2 else y_pad
    oy, ocb, ocr = K.alf_all(
        y_pad, cb, cr, *(to_device(a, device) for a in t["args"]),
        bit_depth=t["bit_depth"], sx=t["sx"], sy=t["sy"],
        has_l=t["has_l"], has_cb=t["has_cb"], has_cr=t["has_cr"],
        has_cc1=t["has_cc1"], has_cc2=t["has_cc2"])
    for comp, on, out in ((0, t["has_l"], oy),
                          (1, t["has_cb"] or t["has_cc1"], ocb),
                          (2, t["has_cr"] or t["has_cc2"], ocr)):
        if on:
            pic.planes[comp][:] = out.cpu().numpy().astype(pic.planes[comp].dtype)
