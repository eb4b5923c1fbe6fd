"""VVC high-level syntax (header) parsing.

Behavioral equivalent of the reference's DecoderLib/VLCReader.cpp
(parseSPS:1277, parsePPS:413, parsePictureHeader:2318, parseSliceHeader:3214,
parseRefPicList:319, parseProfileTierLevel:4354, parseAPS:883) — re-written
as plain functions over the BitReader.  Field names follow the VVC spec
syntax element names.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from vtm_tpu_torch.bitstream.reader import BitReader, NAL_IDR_N_LP, NAL_IDR_W_RADL
from vtm_tpu_torch.common.params import (
    APS,
    ChromaQpTable,
    PPS,
    PicHeader,
    RefPicList,
    SPS,
    SliceHeader,
)
from vtm_tpu_torch.common.types import SliceType

MRG_MAX_NUM_CANDS = 6
AFFINE_MRG_MAX_NUM_CANDS = 5
IBC_MRG_MAX_NUM_CANDS = 6
MAX_QP = 63
PIC_CODE_CW_BINS = 16
MAX_NUM_ALF_CLASSES = 25
MAX_NUM_ALF_LUMA_COEFF = 13
MAX_NUM_ALF_CHROMA_COEFF = 7
MAX_NUM_ALF_ALTERNATIVES_CHROMA = 8
MAX_NUM_CC_ALF_FILTERS = 4
CCALF_BITS_PER_COEFF_LEVEL = 3
CCALF_NUM_COEFF = 8  # 7 signalled + implicit


def ceil_log2(x: int) -> int:
    return 0 if x <= 1 else (x - 1).bit_length()


class ParameterSetManager:
    def __init__(self):
        self.sps: dict[int, SPS] = {}
        self.pps: dict[int, PPS] = {}
        self.vps: dict[int, dict] = {}
        self.aps: dict[tuple[int, int], APS] = {}  # (type, id)

    def store_aps(self, aps: APS):
        self.aps[(aps.aps_type, aps.aps_id)] = aps

    def get_aps(self, aps_type: int, aps_id: int) -> APS:
        return self.aps[(aps_type, aps_id)]


# ---------------------------------------------------------------------------
# profile / tier / level
# ---------------------------------------------------------------------------

def parse_constraint_info(r: BitReader) -> dict:
    c = {}
    for name in ("non_packed", "frame_only", "non_projected", "one_picture_only", "intra_only"):
        c[name] = r.flag()
    c["max_bitdepth"] = r.u(4)
    c["max_chroma_format"] = r.u(2)
    for name in ("single_layer", "all_layers_independent", "no_res_change",
                 "one_tile_per_pic", "pic_header_in_slice_header", "one_slice_per_pic",
                 "one_subpic_per_pic"):
        c[name] = r.flag()
    # 35 remaining no_* tool constraint flags in fixed order
    for name in ("no_qtbtt_dual_tree_intra", "no_partition_constraints_override",
                 "no_sao", "no_alf", "no_ccalf", "no_joint_cbcr", "no_mrl", "no_isp",
                 "no_mip", "no_ref_wraparound", "no_temporal_mvp", "no_sbtmvp",
                 "no_amvr", "no_bdof", "no_dmvr", "no_cclm", "no_mts", "no_sbt",
                 "no_lfnst", "no_affine", "no_mmvd", "no_smvd", "no_prof", "no_bcw",
                 "no_ibc", "no_ciip", "no_gpm", "no_ladf", "no_transform_skip",
                 "no_bdpcm", "no_palette", "no_act", "no_lmcs", "no_qp_delta",
                 "no_dep_quant", "no_sign_data_hiding", "no_mixed_nalu_types",
                 "no_trail", "no_stsa", "no_rasl", "no_radl", "no_idr", "no_cra",
                 "no_gdr", "no_aps"):
        c[name] = r.flag()
    return c


def parse_profile_tier_level(r: BitReader, profile_tier_present: bool, max_sub_layers_minus1: int) -> dict:
    ptl = {}
    if profile_tier_present:
        ptl["profile_idc"] = r.u(7)
        ptl["tier"] = r.flag()
        ptl["constraints"] = parse_constraint_info(r)
    ptl["level_idc"] = r.u(8)
    if profile_tier_present:
        num_sub_profiles = r.u(8)
        ptl["sub_profiles"] = [r.u(32) for _ in range(num_sub_profiles)]
    sub_level_present = [r.flag() for _ in range(max_sub_layers_minus1)]
    while not r.byte_aligned():
        r.u(1)  # ptl_alignment_zero_bit
    for present in sub_level_present:
        if present:
            r.u(8)  # sub_layer_level_idc
    return ptl


# ---------------------------------------------------------------------------
# reference picture list structure
# ---------------------------------------------------------------------------

def parse_ref_pic_list(r: BitReader, sps: SPS, rpl_idx: int) -> RefPicList:
    rpl = RefPicList()
    num = r.ue()
    rpl.num_ref_entries = num
    if sps.long_term_ref_pics and rpl_idx != -1:
        rpl.ltrp_in_slice_header = bool(r.flag())
    elif sps.long_term_ref_pics:
        rpl.ltrp_in_slice_header = True
    prev_delta = None
    first_strp = True
    delta_value = 0
    for ii in range(num):
        is_inter_layer = False
        if sps.inter_layer_ref_pics:
            is_inter_layer = bool(r.flag())
            if is_inter_layer:
                ilrp = r.ue()
                rpl.identifiers.append(0)
                rpl.is_longterm.append(True)
                rpl.is_interlayer.append(True)
                rpl.interlayer_idx.append(ilrp)
                rpl.num_ilrp += 1
        if not is_inter_layer:
            is_lt = False
            if sps.long_term_ref_pics:
                is_lt = r.flag() == 0
            if not is_lt:
                code = r.ue()
                if (not sps.weighted_pred and not sps.weighted_bipred) or ii == 0:
                    code += 1
                read_value = code
                if read_value > 0:
                    sign = r.flag()
                else:
                    sign = 1
                read_value = read_value if sign else -read_value
                if first_strp:
                    first_strp = False
                    prev_delta = delta_value = read_value
                else:
                    delta_value = prev_delta + read_value
                    prev_delta = delta_value
                rpl.identifiers.append(delta_value)
                rpl.is_longterm.append(False)
                rpl.is_interlayer.append(False)
                rpl.interlayer_idx.append(0)
                rpl.num_strp += 1
            else:
                code = 0
                if not rpl.ltrp_in_slice_header:
                    code = r.u(sps.bits_for_poc)
                rpl.identifiers.append(code)
                rpl.is_longterm.append(True)
                rpl.is_interlayer.append(False)
                rpl.interlayer_idx.append(0)
                rpl.num_ltrp += 1
    n = rpl.num_strp + rpl.num_ltrp
    rpl.delta_poc_msb_present = [False] * max(n, num)
    rpl.delta_poc_msb_cycle = [0] * max(n, num)
    return rpl


def _parse_rpl_lt_extras(r: BitReader, sps: SPS, rpl: RefPicList) -> None:
    """Long-term POC extras following an RPL in PH/SH (poc_lsb_lt override,
    delta_poc_msb)."""
    n = rpl.num_ltrp + rpl.num_strp
    for i in range(n):
        rpl.delta_poc_msb_present[i] = False
        rpl.delta_poc_msb_cycle[i] = 0
    if rpl.num_ltrp == 0:
        return
    for i in range(n):
        if rpl.is_longterm[i] and not rpl.is_interlayer[i]:
            if rpl.ltrp_in_slice_header:
                rpl.identifiers[i] = r.u(sps.bits_for_poc)
            present = bool(r.flag())
            rpl.delta_poc_msb_present[i] = present
            if present:
                v = r.ue()
                if i != 0:
                    v += rpl.delta_poc_msb_cycle[i - 1]
                rpl.delta_poc_msb_cycle[i] = v
            elif i != 0:
                rpl.delta_poc_msb_cycle[i] = rpl.delta_poc_msb_cycle[i - 1]
        elif i != 0:
            rpl.delta_poc_msb_cycle[i] = rpl.delta_poc_msb_cycle[i - 1]


# ---------------------------------------------------------------------------
# SPS
# ---------------------------------------------------------------------------

def derive_chroma_qp_tables(
    num_tables: int,
    starts: list[int],
    delta_in_minus1: list[list[int]],
    delta_out: list[list[int]],
    qp_bd_offset: int,
) -> ChromaQpTable:
    """Ref: Slice.cpp ChromaQpMappingTable::derivedChromaQPMappingTables:2851."""
    out = ChromaQpTable()
    for i in range(num_tables):
        npts = len(delta_in_minus1[i])
        qp_in = [starts[i] + 26]
        qp_out = [starts[i] + 26]
        for j in range(npts):
            qp_in.append(qp_in[j] + delta_in_minus1[i][j] + 1)
            qp_out.append(qp_out[j] + delta_out[i][j])
        table = [0] * (MAX_QP + 1 + qp_bd_offset)

        def tset(k, v):
            table[k + qp_bd_offset] = v

        def tget(k):
            return table[k + qp_bd_offset]

        tset(qp_in[0], qp_out[0])
        for k in range(qp_in[0] - 1, -qp_bd_offset - 1, -1):
            tset(k, max(-qp_bd_offset, min(MAX_QP, tget(k + 1) - 1)))
        for j in range(npts):
            sh = (delta_in_minus1[i][j] + 1) >> 1
            m = 1
            for k in range(qp_in[j] + 1, qp_in[j + 1] + 1):
                tset(k, tget(qp_in[j])
                     + ((qp_out[j + 1] - qp_out[j]) * m + sh) // (delta_in_minus1[i][j] + 1))
                m += 1
        for k in range(qp_in[npts] + 1, MAX_QP + 1):
            tset(k, max(-qp_bd_offset, min(MAX_QP, tget(k - 1) + 1)))
        out.tables.append(table)
    return out


def parse_sps(rbsp: bytes) -> SPS:
    r = BitReader(rbsp)
    sps = SPS()
    sps.sps_id = r.u(4)
    sps.vps_id = r.u(4)
    sps.max_sub_layers = r.u(3) + 1
    reserved = r.u(4)
    assert reserved == 0
    sps.ptl_dpb_hrd_present = bool(r.flag())
    if sps.ptl_dpb_hrd_present:
        ptl = parse_profile_tier_level(r, True, sps.max_sub_layers - 1)
        sps.profile_idc = ptl.get("profile_idc", 0)
        sps.level_idc = ptl["level_idc"]
    sps.gdr_enabled = bool(r.flag())
    sps.chroma_format_idc = r.u(2)
    if sps.chroma_format_idc == 3:
        sps.separate_colour_plane = bool(r.flag())
    sps.ref_pic_resampling = bool(r.flag())
    if sps.ref_pic_resampling:
        sps.res_change_in_clvs = bool(r.flag())
    sps.max_pic_width = r.ue()
    sps.max_pic_height = r.ue()
    if r.flag():  # sps_conformance_window_flag
        sps.conf_win = (r.ue(), r.ue(), r.ue(), r.ue())
    sps.log2_ctu_size = r.u(2) + 5
    sps.ctu_size = 1 << sps.log2_ctu_size
    if r.flag():  # subpic_info_present_flag
        sps.num_subpics = r.ue() + 1
        if sps.num_subpics == 1:
            sps.subpic_ctu_top_left = [(0, 0)]
            w_ctu = (sps.max_pic_width + sps.ctu_size - 1) >> sps.log2_ctu_size
            h_ctu = (sps.max_pic_height + sps.ctu_size - 1) >> sps.log2_ctu_size
            sps.subpic_size_ctus = [(w_ctu, h_ctu)]
            sps.subpic_treated_as_pic = [False]
            sps.loop_filter_across_subpic = [True]
            sps.independent_subpics = True
        else:
            sps.independent_subpics = bool(r.flag())
            w_bits = ceil_log2((sps.max_pic_width + sps.ctu_size - 1) // sps.ctu_size)
            h_bits = ceil_log2((sps.max_pic_height + sps.ctu_size - 1) // sps.ctu_size)
            w_ctu_max = (sps.max_pic_width + sps.ctu_size - 1) // sps.ctu_size
            h_ctu_max = (sps.max_pic_height + sps.ctu_size - 1) // sps.ctu_size
            for idx in range(sps.num_subpics):
                tlx = r.u(w_bits) if (idx > 0 and sps.max_pic_width > sps.ctu_size) else 0
                tly = r.u(h_bits) if (idx > 0 and sps.max_pic_height > sps.ctu_size) else 0
                if idx < sps.num_subpics - 1 and sps.max_pic_width > sps.ctu_size:
                    w = r.u(w_bits) + 1
                else:
                    w = w_ctu_max - tlx
                if idx < sps.num_subpics - 1 and sps.max_pic_height > sps.ctu_size:
                    h = r.u(h_bits) + 1
                else:
                    h = h_ctu_max - tly
                sps.subpic_ctu_top_left.append((tlx, tly))
                sps.subpic_size_ctus.append((w, h))
                if not sps.independent_subpics:
                    sps.subpic_treated_as_pic.append(bool(r.flag()))
                    sps.loop_filter_across_subpic.append(bool(r.flag()))
                else:
                    sps.subpic_treated_as_pic.append(True)
                    sps.loop_filter_across_subpic.append(False)
        sps.subpic_id_len = r.ue() + 1
        sps.subpic_id_mapping_explicit = bool(r.flag())
        if sps.subpic_id_mapping_explicit:
            sps.subpic_id_mapping_in_sps = bool(r.flag())
            if sps.subpic_id_mapping_in_sps:
                sps.subpic_ids = [r.u(sps.subpic_id_len) for _ in range(sps.num_subpics)]
    else:
        sps.num_subpics = 1
        w_ctu = (sps.max_pic_width + sps.ctu_size - 1) >> sps.log2_ctu_size
        h_ctu = (sps.max_pic_height + sps.ctu_size - 1) >> sps.log2_ctu_size
        sps.subpic_ctu_top_left = [(0, 0)]
        sps.subpic_size_ctus = [(w_ctu, h_ctu)]
        sps.subpic_treated_as_pic = [False]
        sps.loop_filter_across_subpic = [True]
    if not sps.subpic_id_mapping_explicit or not sps.subpic_id_mapping_in_sps:
        sps.subpic_ids = list(range(sps.num_subpics))
    sps.bit_depth = r.ue() + 8
    sps.qp_bd_offset = 6 * (sps.bit_depth - 8)
    sps.entropy_coding_sync = bool(r.flag())
    sps.entry_point_offsets_present = bool(r.flag())
    sps.bits_for_poc = r.u(4) + 4
    sps.poc_msb_flag = bool(r.flag())
    if sps.poc_msb_flag:
        sps.poc_msb_len = r.ue() + 1
    sps.num_extra_ph_bits = r.u(2)
    sps.extra_ph_bit_present = [bool(r.flag()) for _ in range(8 * sps.num_extra_ph_bits)]
    sps.num_extra_sh_bits = r.u(2)
    sps.extra_sh_bit_present = [bool(r.flag()) for _ in range(8 * sps.num_extra_sh_bits)]
    if sps.ptl_dpb_hrd_present:
        if sps.max_sub_layers - 1 > 0:
            sps.sublayer_dpb_params = bool(r.flag())
        # dpb_parameters
        first = 0 if sps.sublayer_dpb_params else sps.max_sub_layers - 1
        sps.max_dec_pic_buffering = [1] * sps.max_sub_layers
        sps.num_reorder_pics = [0] * sps.max_sub_layers
        for i in range(first, sps.max_sub_layers):
            sps.max_dec_pic_buffering[i] = r.ue() + 1
            sps.num_reorder_pics[i] = r.ue()
            r.ue()  # max_latency_increase_plus1
    if sps.chroma_format_idc != 0:
        sps.dual_i_tree = bool(r.flag())
    sps.log2_min_cb_size = r.ue() + 2
    ctb_log2 = sps.log2_ctu_size
    sps.partition_override_enabled = bool(r.flag())
    min_qt = [0, 0, 0]
    max_btd = [0, 0, 0]
    max_bt = [0, 0, 0]
    max_tt = [0, 0, 0]
    min_qt[0] = 1 << (r.ue() + sps.log2_min_cb_size)
    max_btd[0] = r.ue()
    max_tt[0] = max_bt[0] = min_qt[0]
    if max_btd[0]:
        max_bt[0] <<= r.ue()
        max_tt[0] <<= r.ue()
    min_qt[1] = 1 << (r.ue() + sps.log2_min_cb_size)
    max_btd[1] = r.ue()
    max_tt[1] = max_bt[1] = min_qt[1]
    if max_btd[1]:
        max_bt[1] <<= r.ue()
        max_tt[1] <<= r.ue()
    if sps.dual_i_tree:
        min_qt[2] = 1 << (r.ue() + sps.log2_min_cb_size)
        max_btd[2] = r.ue()
        max_tt[2] = max_bt[2] = min_qt[2]
        if max_btd[2]:
            max_bt[2] <<= r.ue()
            max_tt[2] <<= r.ue()
    sps.min_qt_size, sps.max_mtt_depth = min_qt, max_btd
    sps.max_bt_size, sps.max_tt_size = max_bt, max_tt
    if sps.ctu_size > 32:
        sps.log2_max_tb_size = (1 if r.flag() else 0) + 5
    else:
        sps.log2_max_tb_size = 5
    chroma_array_type = 0 if sps.separate_colour_plane else sps.chroma_format_idc
    if chroma_array_type != 0:
        sps.joint_cbcr = bool(r.flag())
        sps.same_qp_table_for_chroma = bool(r.flag())
        num_tables = 1 if sps.same_qp_table_for_chroma else (3 if sps.joint_cbcr else 2)
        starts, din, dout = [], [], []
        for _ in range(num_tables):
            starts.append(r.se())
            npts = r.ue() + 1
            a, b = [], []
            for _ in range(npts):
                v = r.ue()
                d = r.ue()
                a.append(v)
                b.append(d ^ v)
            din.append(a)
            dout.append(b)
        sps.chroma_qp_table = derive_chroma_qp_tables(
            num_tables, starts, din, dout, sps.qp_bd_offset
        )
    sps.sao = bool(r.flag())
    sps.alf = bool(r.flag())
    if sps.alf and sps.chroma_format_idc != 0:
        sps.ccalf = bool(r.flag())
    sps.transform_skip = bool(r.flag())
    if sps.transform_skip:
        sps.log2_max_ts_size = r.ue() + 2
        sps.bdpcm = bool(r.flag())
    sps.weighted_pred = bool(r.flag())
    sps.weighted_bipred = bool(r.flag())
    sps.long_term_ref_pics = bool(r.flag())
    if sps.vps_id > 0:
        sps.inter_layer_ref_pics = bool(r.flag())
    sps.idr_rpl_present = bool(r.flag())
    sps.rpl1_copy_from_rpl0 = bool(r.flag())
    num0 = r.ue()
    list0 = [parse_ref_pic_list(r, sps, i) for i in range(num0)]
    if not sps.rpl1_copy_from_rpl0:
        num1 = r.ue()
        list1 = [parse_ref_pic_list(r, sps, i) for i in range(num1)]
    else:
        list1 = [rpl.copy() for rpl in list0]
    sps.rpl_lists = (list0, list1)
    sps.ref_wraparound = bool(r.flag())
    sps.temporal_mvp = bool(r.flag())
    if sps.temporal_mvp:
        sps.sbtmvp = bool(r.flag())
    sps.amvr = bool(r.flag())
    sps.bdof = bool(r.flag())
    if sps.bdof:
        sps.bdof_control_present = bool(r.flag())
    sps.smvd = bool(r.flag())
    sps.dmvr = bool(r.flag())
    if sps.dmvr:
        sps.dmvr_control_present = bool(r.flag())
    sps.mmvd = bool(r.flag())
    if sps.mmvd:
        sps.mmvd_fullpel_only = bool(r.flag())
    sps.max_num_merge_cand = MRG_MAX_NUM_CANDS - r.ue()
    sps.sbt = bool(r.flag())
    sps.affine = bool(r.flag())
    if sps.affine:
        sps.max_num_affine_merge_cand = AFFINE_MRG_MAX_NUM_CANDS - r.ue()
        sps.affine_type = bool(r.flag())
        if sps.amvr:
            sps.affine_amvr = bool(r.flag())
        sps.prof = bool(r.flag())
        if sps.prof:
            sps.prof_control_present = bool(r.flag())
    sps.bcw = bool(r.flag())
    sps.ciip = bool(r.flag())
    if sps.max_num_merge_cand >= 2:
        sps.geo = bool(r.flag())
        if sps.geo and sps.max_num_merge_cand >= 3:
            sps.max_num_geo_cand = sps.max_num_merge_cand - r.ue()
        elif sps.geo:
            sps.max_num_geo_cand = 2
    sps.log2_parallel_merge_level = r.ue() + 2
    sps.isp = bool(r.flag())
    sps.mrl = bool(r.flag())
    sps.mip = bool(r.flag())
    if sps.chroma_format_idc != 0:
        sps.cclm = bool(r.flag())
    if sps.chroma_format_idc == 1:
        sps.chroma_hor_collocated = bool(r.flag())
        sps.chroma_ver_collocated = bool(r.flag())
    sps.mts = bool(r.flag())
    if sps.mts:
        sps.explicit_mts_intra = bool(r.flag())
        sps.explicit_mts_inter = bool(r.flag())
    sps.palette = bool(r.flag())
    if chroma_array_type == 3 and sps.log2_max_tb_size != 6:
        sps.act = bool(r.flag())
    if sps.transform_skip or sps.palette:
        sps.internal_minus_input_bd = r.ue()
    sps.ibc = bool(r.flag())
    if sps.ibc:
        sps.max_num_ibc_merge_cand = IBC_MRG_MAX_NUM_CANDS - r.ue()
    sps.lmcs = bool(r.flag())
    sps.lfnst = bool(r.flag())
    sps.ladf = bool(r.flag())
    if sps.ladf:
        raise NotImplementedError("LADF not supported")
    sps.explicit_scaling_list = bool(r.flag())
    if sps.lfnst and sps.explicit_scaling_list:
        sps.scaling_matrix_for_lfnst_disabled = bool(r.flag())
    sps.scaling_matrix_alt_colour_disabled = False
    sps.scaling_matrix_designated_colour = False
    if sps.act and sps.explicit_scaling_list:
        sps.scaling_matrix_alt_colour_disabled = bool(r.flag())
    if sps.scaling_matrix_alt_colour_disabled:
        sps.scaling_matrix_designated_colour = bool(r.flag())
    sps.dep_quant = bool(r.flag())
    sps.sign_data_hiding = bool(r.flag())
    sps.virtual_boundaries_enabled = bool(r.flag())
    if sps.virtual_boundaries_enabled:
        sps.virtual_boundaries_present = bool(r.flag())
        if sps.virtual_boundaries_present:
            sps.num_ver_vbs = r.u(2)
            sps.vb_pos_x = [r.ue() << 3 for _ in range(sps.num_ver_vbs)]
            sps.num_hor_vbs = r.u(2)
            sps.vb_pos_y = [r.ue() << 3 for _ in range(sps.num_hor_vbs)]
    if sps.ptl_dpb_hrd_present:
        if r.flag():  # sps_general_hrd_params_present_flag
            sps.general_hrd = parse_general_hrd(r)
            sublayer_cpb = (bool(r.flag())
                            if sps.max_sub_layers > 1 else False)
            first = 0 if sublayer_cpb else sps.max_sub_layers - 1
            sps.ols_hrd = parse_ols_hrd(r, sps.general_hrd, first,
                                        sps.max_sub_layers - 1)
    sps.field_seq = bool(r.flag())
    if r.flag():  # vui_parameters_present_flag
        sps.vui = parse_vui(r)
    if r.flag():  # sps_extension_present_flag
        raise NotImplementedError("SPS extensions not supported")
    return sps


def parse_general_hrd(r) -> dict:
    """general_hrd_parameters() — HRD timing/buffering model header
    (VLCReader.cpp parseGeneralHrdParameters behavior)."""
    g = {}
    g["num_units_in_tick"] = r.u(32)
    g["time_scale"] = r.u(32)
    g["nal_hrd"] = bool(r.flag())
    g["vcl_hrd"] = bool(r.flag())
    g["same_pic_timing_in_all_ols"] = bool(r.flag())
    g["du_hrd"] = bool(r.flag())
    if g["du_hrd"]:
        g["tick_divisor_minus2"] = r.u(8)
    g["bit_rate_scale"] = r.u(4)
    g["cpb_size_scale"] = r.u(4)
    if g["du_hrd"]:
        g["cpb_size_du_scale"] = r.u(4)
    g["cpb_cnt_minus1"] = r.ue()
    return g


def parse_ols_hrd(r, g: dict, first: int, max_sl: int) -> list:
    """ols_hrd_parameters() for sublayers [first..max_sl]; lower layers
    inherit the highest layer's values (reference behavior)."""
    out = [None] * (max_sl + 1)
    for i in range(first, max_sl + 1):
        h = {}
        h["fixed_pic_rate_general"] = bool(r.flag())
        h["fixed_pic_rate_cvs"] = (True if h["fixed_pic_rate_general"]
                                   else bool(r.flag()))
        h["low_delay_hrd"] = False
        if h["fixed_pic_rate_cvs"]:
            h["elemental_duration_in_tc_minus1"] = r.ue()
        elif g["cpb_cnt_minus1"] == 0:
            h["low_delay_hrd"] = bool(r.flag())
        cpb = []
        for nal_or_vcl in range(2):
            if (nal_or_vcl == 0 and g["nal_hrd"]) or (
                    nal_or_vcl == 1 and g["vcl_hrd"]):
                for _ in range(g["cpb_cnt_minus1"] + 1):
                    e = {"bit_rate_value_minus1": r.ue(),
                         "cpb_size_value_minus1": r.ue()}
                    if g["du_hrd"]:
                        e["bit_rate_du_value_minus1"] = r.ue()
                        e["cpb_size_du_value_minus1"] = r.ue()
                    e["cbr"] = bool(r.flag())
                    cpb.append(e)
        h["cpb"] = cpb
        out[i] = h
    for i in range(first):
        out[i] = out[max_sl]
    return out


def parse_vui(r) -> dict:
    """vui_parameters() (VTM 9.3 draft form — no payload-size wrapper)."""
    v = {}
    v["progressive_source"] = bool(r.flag())
    v["interlaced_source"] = bool(r.flag())
    if r.flag():  # aspect_ratio_info_present
        v["aspect_ratio_constant"] = bool(r.flag())
        v["aspect_ratio_idc"] = r.u(8)
        if v["aspect_ratio_idc"] == 255:
            v["sar_width"] = r.u(16)
            v["sar_height"] = r.u(16)
    if r.flag():  # overscan_info_present
        v["overscan_appropriate"] = bool(r.flag())
    if r.flag():  # colour_description_present
        v["colour_primaries"] = r.u(8)
        v["transfer_characteristics"] = r.u(8)
        v["matrix_coeffs"] = r.u(8)
        v["full_range"] = bool(r.flag())
    if r.flag():  # chroma_loc_info_present
        if v["progressive_source"] and not v["interlaced_source"]:
            v["chroma_sample_loc_type"] = r.ue()
        else:
            v["chroma_sample_loc_type_top"] = r.ue()
            v["chroma_sample_loc_type_bottom"] = r.ue()
    return v


# ---------------------------------------------------------------------------
# VPS / DCI
# ---------------------------------------------------------------------------

def parse_dci(rbsp: bytes) -> dict:
    """Decoding capability information NAL (VLCReader.cpp parseDCI
    behavior): a list of profile_tier_level structures."""
    r = BitReader(rbsp)
    r.u(4)  # dci_reserved_zero_4bits
    n = r.u(4) + 1
    return {"ptls": [parse_profile_tier_level(r, True, 0)
                     for _ in range(n)]}


def parse_vps(rbsp: bytes) -> dict:
    """Video parameter set body (VLCReader.cpp parseVPS behavior):
    layer/sublayer structure, direct-dependency flags, output-layer-set
    modes with the OLS count derivation, per-OLS PTL/DPB/HRD tables."""
    r = BitReader(rbsp)
    v: dict = {}
    v["vps_id"] = r.u(4)
    max_layers = r.u(6) + 1
    v["max_layers"] = max_layers
    max_sl = r.u(3) + 1
    v["max_sublayers"] = max_sl
    all_same_sl = True
    if max_layers > 1 and max_sl > 1:
        all_same_sl = bool(r.flag())
    v["all_layers_same_num_sublayers"] = all_same_sl
    all_indep = True
    if max_layers > 1:
        all_indep = bool(r.flag())
    v["all_independent_layers"] = all_indep
    v["layer_id"] = [0] * max_layers
    dep = [[0] * max_layers for _ in range(max_layers)]
    v["max_tid_il_ref_pics_plus1"] = [7] * max_layers
    for i in range(max_layers):
        v["layer_id"][i] = r.u(6)
        if i > 0 and not all_indep:
            indep = bool(r.flag())
            if not indep:
                for j in range(i):
                    dep[i][j] = r.flag()
                if r.flag():  # max_tid_ref_present
                    v["max_tid_il_ref_pics_plus1"][i] = r.u(3)
    v["direct_ref_layer"] = dep
    each_ols = max_layers == 1 or all_indep
    ols_mode = 0
    num_explicit_ols = 1
    ols_output = []
    if max_layers > 1:
        if all_indep:
            each_ols = bool(r.flag())
            if not each_ols:
                ols_mode = 2
        if not each_ols:
            if not all_indep:
                ols_mode = r.u(2)
            if ols_mode == 2:
                num_explicit_ols = r.u(8) + 1
                ols_output = [[r.flag() for _ in range(max_layers)]
                              for _ in range(num_explicit_ols - 1)]
    v["each_layer_is_an_ols"] = each_ols
    v["ols_mode_idc"] = ols_mode
    # ---- OLS derivation (VPS::deriveOutputLayerSets subset needed for
    # parsing: per-OLS layer counts) ----
    if max_layers == 1:
        total_ols = 1
    elif each_ols or ols_mode < 2:
        total_ols = max_layers
    else:
        total_ols = num_explicit_ols
    # transitive dependency closure for mode-2 layer inclusion
    closure = [row[:] for row in dep]
    for i in range(max_layers):
        for k in range(i):
            if dep[i][k]:
                for j in range(max_layers):
                    closure[i][j] |= closure[k][j]
    layers_in_ols = []
    for i in range(total_ols):
        if max_layers == 1 or each_ols:
            layers_in_ols.append(1)
        elif ols_mode in (0, 1):
            layers_in_ols.append(i + 1)
        else:  # mode 2: output layers + their dependencies
            if i == 0:
                layers_in_ols.append(1)
                continue
            inc = [0] * max_layers
            for j in range(max_layers):
                if ols_output[i - 1][j]:
                    inc[j] = 1
                    for k in range(max_layers):
                        if closure[j][k]:
                            inc[k] = 1
            layers_in_ols.append(sum(inc))
    v["total_num_olss"] = total_ols
    v["num_layers_in_ols"] = layers_in_ols
    num_multi = sum(1 for n in layers_in_ols if n > 1)
    v["num_multi_layered_olss"] = num_multi
    # ---- per-OLS PTL ----
    num_ptls = r.u(8) + 1
    pt_present = [True] + [bool(r.flag()) for _ in range(num_ptls - 1)]
    ptl_max_tid = [r.u(3) if not all_same_sl else max_sl - 1
                   for _ in range(num_ptls)]
    r.align()
    v["ptls"] = [parse_profile_tier_level(r, pt_present[i],
                                          ptl_max_tid[i] - 1)
                 for i in range(num_ptls)]
    v["ols_ptl_idx"] = []
    for i in range(total_ols):
        if num_ptls > 1 and num_ptls != total_ols:
            v["ols_ptl_idx"].append(r.u(8))
        elif num_ptls == total_ols:
            v["ols_ptl_idx"].append(i)
        else:
            v["ols_ptl_idx"].append(0)
    # ---- DPB parameters (multi-layer OLSs only) ----
    if not each_ols:
        num_dpb = r.ue() + 1
        sub_dpb = bool(r.flag()) if (num_dpb > 0 and max_sl > 1) else False
        dpbs = []
        for _ in range(num_dpb):
            max_tid = r.u(3) if not all_same_sl else max_sl - 1
            ent = []
            for _j in range(0 if sub_dpb else max_tid, max_tid + 1):
                ent.append({"max_dec_pic_buffering_minus1": r.ue(),
                            "max_num_reorder_pics": r.ue(),
                            "max_latency_increase_plus1": r.ue()})
            dpbs.append({"max_tid": max_tid, "sublayers": ent})
        v["dpb_params"] = dpbs
        v["ols_dpb"] = []
        for i in range(total_ols):
            if layers_in_ols[i] > 1:
                e = {"pic_width": r.ue(), "pic_height": r.ue(),
                     "chroma_format_idc": r.u(2),
                     "bitdepth_minus8": r.ue()}
                if num_dpb > 1 and num_dpb != num_multi:
                    e["dpb_params_idx"] = r.ue()
                v["ols_dpb"].append(e)
        hrd_present = bool(r.flag())
    else:
        hrd_present = False
    if hrd_present:
        g = parse_general_hrd(r)
        v["general_hrd"] = g
        sub_cpb = bool(r.flag()) if max_sl > 1 else False
        n_hrd = r.ue() + 1
        v["ols_hrd"] = []
        for _ in range(n_hrd):
            hrd_max_tid = r.u(3) if not all_same_sl else max_sl - 1
            first = 0 if sub_cpb else hrd_max_tid
            v["ols_hrd"].append(parse_ols_hrd(r, g, first, hrd_max_tid))
        for i in range(num_multi):
            if n_hrd != num_multi and n_hrd > 1:
                r.ue()  # ols_hrd_idx
    r.flag()  # vps_extension_flag (payload skipped)
    return v


# ---------------------------------------------------------------------------
# PPS
# ---------------------------------------------------------------------------

def parse_pps(rbsp: bytes) -> PPS:
    r = BitReader(rbsp)
    pps = PPS()
    pps.pps_id = r.u(6)
    pps.sps_id = r.u(4)
    pps.mixed_nalu_types = bool(r.flag())
    pps.pic_width = r.ue()
    pps.pic_height = r.ue()
    if r.flag():  # pps_conformance_window_flag
        pps.conf_win = (r.ue(), r.ue(), r.ue(), r.ue())
    if r.flag():  # scaling_window_flag
        pps.scaling_win = (r.se(), r.se(), r.se(), r.se())
    else:
        pps.scaling_win = pps.conf_win
    pps.output_flag_present = bool(r.flag())
    pps.no_pic_partition = bool(r.flag())
    pps.subpic_id_mapping_in_pps = bool(r.flag())
    if pps.subpic_id_mapping_in_pps:
        if not pps.no_pic_partition:
            pps.num_subpics = r.ue() + 1
        else:
            pps.num_subpics = 1
        pps.subpic_id_len = r.ue() + 1
        pps.subpic_ids = [r.u(pps.subpic_id_len) for _ in range(pps.num_subpics)]
    if not pps.no_pic_partition:
        pps.log2_ctu_size = r.u(2) + 5
        ctu = 1 << pps.log2_ctu_size
        pic_w_ctu = pps.pic_width_in_ctu(ctu)
        pic_h_ctu = pps.pic_height_in_ctu(ctu)
        pps.num_exp_tile_cols = r.ue() + 1
        pps.num_exp_tile_rows = r.ue() + 1
        pps.tile_col_widths = [r.ue() + 1 for _ in range(pps.num_exp_tile_cols)]
        pps.tile_row_heights = [r.ue() + 1 for _ in range(pps.num_exp_tile_rows)]
        init_tiles(pps)
        if pps.num_tiles > 1:
            pps.loop_filter_across_tiles = bool(r.u(1))
            pps.rect_slice = bool(r.u(1))
        else:
            pps.loop_filter_across_tiles = True
            pps.rect_slice = True
        if pps.rect_slice:
            pps.single_slice_per_subpic = bool(r.flag())
        else:
            pps.single_slice_per_subpic = False
        if pps.rect_slice and not pps.single_slice_per_subpic:
            _parse_rect_slices(r, pps)
        if (not pps.rect_slice) or pps.single_slice_per_subpic or pps.num_slices_in_pic > 1:
            pps.loop_filter_across_slices = bool(r.u(1))
        else:
            pps.loop_filter_across_slices = False
    else:
        pps.single_slice_per_subpic = True
    pps.cabac_init_present = bool(r.flag())
    pps.num_ref_idx_default = (r.ue() + 1, r.ue() + 1)
    pps.rpl1_idx_present = bool(r.flag())
    pps.init_qp = 26 + r.se()
    pps.cu_qp_delta_enabled = bool(r.flag())
    pps.chroma_tool_offsets_present = bool(r.flag())
    if pps.chroma_tool_offsets_present:
        pps.cb_qp_offset = r.se()
        pps.cr_qp_offset = r.se()
        pps.joint_cbcr_qp_offset_present = bool(r.flag())
        pps.joint_cbcr_qp_offset = r.se() if pps.joint_cbcr_qp_offset_present else 0
        pps.slice_chroma_qp_flag = bool(r.flag())
        if r.flag():  # pps_cu_chroma_qp_offset_list_enabled_flag
            n = r.ue() + 1
            for _ in range(n):
                cb = r.se()
                cr = r.se()
                jj = r.se() if pps.joint_cbcr_qp_offset_present else 0
                pps.chroma_qp_offset_list.append((cb, cr, jj))
    pps.weighted_pred = bool(r.flag())
    pps.weighted_bipred = bool(r.flag())
    pps.deblocking_filter_control_present = bool(r.flag())
    if pps.deblocking_filter_control_present:
        pps.deblocking_filter_override_enabled = bool(r.flag())
        pps.deblocking_filter_disabled = bool(r.flag())
        if not pps.no_pic_partition and pps.deblocking_filter_override_enabled:
            pps.dbf_info_in_ph = bool(r.flag())
        if not pps.deblocking_filter_disabled:
            pps.beta_offset_div2 = r.se()
            pps.tc_offset_div2 = r.se()
            if pps.chroma_tool_offsets_present:
                pps.cb_beta_offset_div2 = r.se()
                pps.cb_tc_offset_div2 = r.se()
                pps.cr_beta_offset_div2 = r.se()
                pps.cr_tc_offset_div2 = r.se()
            else:
                pps.cb_beta_offset_div2 = pps.cr_beta_offset_div2 = pps.beta_offset_div2
                pps.cb_tc_offset_div2 = pps.cr_tc_offset_div2 = pps.tc_offset_div2
    if not pps.no_pic_partition:
        pps.rpl_info_in_ph = bool(r.flag())
        pps.sao_info_in_ph = bool(r.flag())
        pps.alf_info_in_ph = bool(r.flag())
        if (pps.weighted_pred or pps.weighted_bipred) and pps.rpl_info_in_ph:
            pps.wp_info_in_ph = bool(r.flag())
        pps.qp_delta_info_in_ph = bool(r.flag())
    pps.wraparound = bool(r.flag())
    if pps.wraparound:
        pps.pic_width_minus_wraparound_offset = r.ue()
    pps.picture_header_extension_present = bool(r.flag())
    pps.slice_header_extension_present = bool(r.flag())
    if r.flag():
        while r.more_rbsp_data():
            r.flag()
    return pps


def _parse_rect_slices(r: BitReader, pps: PPS) -> None:
    """Rect-slice layout (parsePPS rect slice section, VLCReader.cpp:488+)."""
    pps.num_slices_in_pic = r.ue() + 1
    n = pps.num_slices_in_pic
    if n - 1 > 1:
        pps.tile_idx_delta_present = bool(r.u(1))
    pps.slice_tile_idx = [0] * n
    pps.slice_width_in_tiles = [1] * n
    pps.slice_height_in_tiles = [1] * n
    pps.num_slices_in_tile = [1] * n
    pps.slice_height_in_ctu = [0] * n
    tile_idx = 0
    i = 0
    while i < n - 1:
        pps.slice_tile_idx[i] = tile_idx
        if tile_idx % pps.num_tile_cols != pps.num_tile_cols - 1:
            pps.slice_width_in_tiles[i] = r.ue() + 1
        else:
            pps.slice_width_in_tiles[i] = 1
        if tile_idx // pps.num_tile_cols != pps.num_tile_rows - 1 and (
            pps.tile_idx_delta_present or tile_idx % pps.num_tile_cols == 0
        ):
            pps.slice_height_in_tiles[i] = r.ue() + 1
        else:
            if tile_idx // pps.num_tile_cols == pps.num_tile_rows - 1:
                pps.slice_height_in_tiles[i] = 1
            else:
                pps.slice_height_in_tiles[i] = pps.slice_height_in_tiles[i - 1]
        if pps.slice_width_in_tiles[i] == 1 and pps.slice_height_in_tiles[i] == 1:
            row_h = pps.tile_row_heights[tile_idx // pps.num_tile_cols]
            if row_h > 1:
                num_exp = r.ue()
                if num_exp == 0:
                    pps.num_slices_in_tile[i] = 1
                    pps.slice_height_in_ctu[i] = row_h
                else:
                    rem = row_h
                    j = 0
                    last = 0
                    for j in range(num_exp):
                        last = r.ue() + 1
                        pps.slice_height_in_ctu[i + j] = last
                        rem -= last
                    j = num_exp
                    while rem >= last:
                        pps.slice_height_in_ctu[i + j] = last
                        rem -= last
                        j += 1
                    if rem > 0:
                        pps.slice_height_in_ctu[i + j] = rem
                        j += 1
                    for k in range(j):
                        pps.num_slices_in_tile[i + k] = j
                        pps.slice_width_in_tiles[i + k] = 1
                        pps.slice_height_in_tiles[i + k] = 1
                        pps.slice_tile_idx[i + k] = tile_idx
                    i += j - 1
            else:
                pps.num_slices_in_tile[i] = 1
                pps.slice_height_in_ctu[i] = row_h
        if i < n - 1:
            if pps.tile_idx_delta_present:
                tile_idx += r.se()
            else:
                tile_idx += pps.slice_width_in_tiles[i]
                if tile_idx % pps.num_tile_cols == 0:
                    tile_idx += (pps.slice_height_in_tiles[i] - 1) * pps.num_tile_cols
        i += 1
    pps.slice_tile_idx[n - 1] = tile_idx


def init_tiles(pps: PPS) -> None:
    """Ref: PPS::initTiles (Slice.cpp:3050)."""
    ctu = 1 << pps.log2_ctu_size
    pic_w = pps.pic_width_in_ctu(ctu)
    pic_h = pps.pic_height_in_ctu(ctu)
    for sizes, total in ((pps.tile_col_widths, pic_w), (pps.tile_row_heights, pic_h)):
        remaining = total - sum(sizes)
        uniform = sizes[-1]
        while remaining > 0:
            uniform = min(remaining, uniform)
            sizes.append(uniform)
            remaining -= uniform
    pps.tile_col_bd = [0]
    for w in pps.tile_col_widths:
        pps.tile_col_bd.append(pps.tile_col_bd[-1] + w)
    pps.tile_row_bd = [0]
    for h in pps.tile_row_heights:
        pps.tile_row_bd.append(pps.tile_row_bd[-1] + h)
    pps.ctu_to_tile_col = []
    for col, w in enumerate(pps.tile_col_widths):
        pps.ctu_to_tile_col += [col] * w
    pps.ctu_to_tile_row = []
    for row, h in enumerate(pps.tile_row_heights):
        pps.ctu_to_tile_row += [row] * h


def _ctus_in_rect(x0, x1, y0, y1, pic_w_ctu):
    return [y * pic_w_ctu + x for y in range(y0, y1) for x in range(x0, x1)]


def derive_pps_partitioning(pps: PPS, sps: SPS) -> None:
    """PH-time PPS fixups (parsePictureHeader: no-partition defaults +
    initRectSliceMap, Slice.cpp:3146)."""
    if pps.no_pic_partition:
        pps.log2_ctu_size = sps.log2_ctu_size
        ctu = sps.ctu_size
        pps.tile_col_widths = [pps.pic_width_in_ctu(ctu)]
        pps.tile_row_heights = [pps.pic_height_in_ctu(ctu)]
        init_tiles(pps)
        pps.rect_slice = True
        pps.num_slices_in_pic = 1
        pps.tile_idx_delta_present = False
        pps.slice_tile_idx = [0]
        pps.slice_width_in_tiles = [1]
        pps.slice_height_in_tiles = [1]
        pps.num_slices_in_tile = [1]
        pps.slice_height_in_ctu = [pps.pic_height_in_ctu(ctu)]
        init_rect_slice_map(pps, sps)
    elif pps.rect_slice:
        init_rect_slice_map(pps, sps)
    if pps.wraparound:
        min_cb = 1 << sps.log2_min_cb_size
        pps.wraparound_offset = min_cb * (
            pps.pic_width // min_cb - pps.pic_width_minus_wraparound_offset
        )
    else:
        pps.wraparound_offset = 0


def init_rect_slice_map(pps: PPS, sps: SPS) -> None:
    pic_w = pps.pic_width_in_ctu(1 << pps.log2_ctu_size)
    cb = pps.tile_col_bd
    rb = pps.tile_row_bd
    if pps.single_slice_per_subpic:
        if sps.num_subpics > 1:
            pps.num_slices_in_pic = sps.num_subpics
            pps.slice_ctu_addrs = []
            for i in range(sps.num_subpics):
                tlx, tly = sps.subpic_ctu_top_left[i]
                w, h = sps.subpic_size_ctus[i]
                sub_h_tiles = pps.ctu_to_tile_row[tly + h - 1] + 1 - pps.ctu_to_tile_row[tly]
                less_than_tile = (
                    sub_h_tiles == 1 and h < pps.tile_row_heights[pps.ctu_to_tile_row[tly]]
                )
                addrs = []
                if less_than_tile:
                    addrs += _ctus_in_rect(tlx, tlx + w, tly, tly + h, pic_w)
                else:
                    tx = pps.ctu_to_tile_col[tlx]
                    ty = pps.ctu_to_tile_row[tly]
                    sub_w_tiles = pps.ctu_to_tile_col[tlx + w - 1] + 1 - tx
                    for j in range(sub_h_tiles):
                        for k in range(sub_w_tiles):
                            addrs += _ctus_in_rect(
                                cb[tx + k], cb[tx + k + 1], rb[ty + j], rb[ty + j + 1], pic_w
                            )
                pps.slice_ctu_addrs.append(addrs)
        else:
            addrs = []
            for ty in range(pps.num_tile_rows):
                for tx in range(pps.num_tile_cols):
                    addrs += _ctus_in_rect(cb[tx], cb[tx + 1], rb[ty], rb[ty + 1], pic_w)
            pps.num_slices_in_pic = 1
            pps.slice_ctu_addrs = [addrs]
    else:
        n = pps.num_slices_in_pic
        pps.slice_ctu_addrs = [[] for _ in range(n)]
        i = 0
        while i < n:
            tx = pps.slice_tile_idx[i] % pps.num_tile_cols
            ty = pps.slice_tile_idx[i] // pps.num_tile_cols
            if i == n - 1:
                pps.slice_width_in_tiles[i] = pps.num_tile_cols - tx
                pps.slice_height_in_tiles[i] = pps.num_tile_rows - ty
                pps.num_slices_in_tile[i] = 1
            if pps.slice_width_in_tiles[i] > 1 or pps.slice_height_in_tiles[i] > 1:
                for j in range(pps.slice_height_in_tiles[i]):
                    for k in range(pps.slice_width_in_tiles[i]):
                        pps.slice_ctu_addrs[i] += _ctus_in_rect(
                            cb[tx + k], cb[tx + k + 1], rb[ty + j], rb[ty + j + 1], pic_w
                        )
            else:
                num_in_tile = pps.num_slices_in_tile[i]
                ctu_y = rb[ty]
                for _ in range(num_in_tile - 1):
                    pps.slice_ctu_addrs[i] += _ctus_in_rect(
                        cb[tx], cb[tx + 1], ctu_y, ctu_y + pps.slice_height_in_ctu[i], pic_w
                    )
                    ctu_y += pps.slice_height_in_ctu[i]
                    i += 1
                pps.slice_height_in_ctu[i] = rb[ty + 1] - ctu_y
                pps.slice_ctu_addrs[i] += _ctus_in_rect(
                    cb[tx], cb[tx + 1], ctu_y, rb[ty + 1], pic_w
                )
            i += 1


# ---------------------------------------------------------------------------
# APS
# ---------------------------------------------------------------------------

@dataclass
class AlfParam:
    new_filter_luma: bool = False
    new_filter_chroma: bool = False
    nonlinear_luma: bool = False
    nonlinear_chroma: bool = False
    num_luma_filters: int = 1
    filter_coeff_delta_idx: list[int] = field(default_factory=lambda: [0] * MAX_NUM_ALF_CLASSES)
    luma_coeff: list[list[int]] = field(
        default_factory=lambda: [[0] * MAX_NUM_ALF_LUMA_COEFF for _ in range(MAX_NUM_ALF_CLASSES)]
    )
    luma_clip: list[list[int]] = field(
        default_factory=lambda: [[0] * MAX_NUM_ALF_LUMA_COEFF for _ in range(MAX_NUM_ALF_CLASSES)]
    )
    num_alternatives_chroma: int = 1
    chroma_coeff: list[list[int]] = field(
        default_factory=lambda: [[0] * MAX_NUM_ALF_CHROMA_COEFF
                                 for _ in range(MAX_NUM_ALF_ALTERNATIVES_CHROMA)]
    )
    chroma_clip: list[list[int]] = field(
        default_factory=lambda: [[0] * MAX_NUM_ALF_CHROMA_COEFF
                                 for _ in range(MAX_NUM_ALF_ALTERNATIVES_CHROMA)]
    )
    # CC-ALF
    new_ccalf: list[bool] = field(default_factory=lambda: [False, False])
    ccalf_filter_count: list[int] = field(default_factory=lambda: [0, 0])
    ccalf_coeff: list[list[list[int]]] = field(
        default_factory=lambda: [
            [[0] * CCALF_NUM_COEFF for _ in range(MAX_NUM_CC_ALF_FILTERS)] for _ in range(2)
        ]
    )
    ccalf_enabled_idx: list[list[bool]] = field(
        default_factory=lambda: [[False] * MAX_NUM_CC_ALF_FILTERS for _ in range(2)]
    )


def _parse_alf_filter(r: BitReader, p: AlfParam, is_chroma: bool, alt_idx: int) -> None:
    num_coeff = 7 if is_chroma else 13
    num_filters = 1 if is_chroma else p.num_luma_filters
    coeff = [p.chroma_coeff[alt_idx]] if is_chroma else p.luma_coeff
    clipp = [p.chroma_clip[alt_idx]] if is_chroma else p.luma_clip
    for ind in range(num_filters):
        for i in range(num_coeff - 1):
            v = r.ue()
            if v and r.flag():
                v = -v
            coeff[ind][i] = v
    nonlinear = p.nonlinear_chroma if is_chroma else p.nonlinear_luma
    if nonlinear:
        for ind in range(num_filters):
            for i in range(num_coeff - 1):
                clipp[ind][i] = r.u(2)
    else:
        for ind in range(num_filters):
            for i in range(num_coeff):
                clipp[ind][i] = 0


def parse_aps(rbsp: bytes) -> APS:
    r = BitReader(rbsp)
    aps = APS()
    aps.aps_id = r.u(5)
    aps.aps_type = r.u(3)
    if aps.aps_type == 0:  # ALF
        p = AlfParam()
        p.new_filter_luma = bool(r.flag())
        p.new_filter_chroma = bool(r.flag())
        p.new_ccalf[0] = bool(r.flag())
        p.new_ccalf[1] = bool(r.flag())
        if p.new_filter_luma:
            p.nonlinear_luma = bool(r.flag())
            p.num_luma_filters = r.ue() + 1
            if p.num_luma_filters > 1:
                length = ceil_log2(p.num_luma_filters)
                for i in range(MAX_NUM_ALF_CLASSES):
                    p.filter_coeff_delta_idx[i] = r.u(length)
            _parse_alf_filter(r, p, False, 0)
        if p.new_filter_chroma:
            p.nonlinear_chroma = bool(r.flag())
            p.num_alternatives_chroma = r.ue() + 1 if MAX_NUM_ALF_ALTERNATIVES_CHROMA > 1 else 1
            for alt in range(p.num_alternatives_chroma):
                _parse_alf_filter(r, p, True, alt)
        for cc_idx in range(2):
            if p.new_ccalf[cc_idx]:
                cnt = (r.ue() if MAX_NUM_CC_ALF_FILTERS > 1 else 0) + 1
                p.ccalf_filter_count[cc_idx] = cnt
                for f in range(cnt):
                    p.ccalf_enabled_idx[cc_idx][f] = True
                    for i in range(CCALF_NUM_COEFF - 1):
                        code = r.u(CCALF_BITS_PER_COEFF_LEVEL)
                        if code == 0:
                            p.ccalf_coeff[cc_idx][f][i] = 0
                        else:
                            v = 1 << (code - 1)
                            if r.flag():
                                v = -v
                            p.ccalf_coeff[cc_idx][f][i] = v
        aps.alf = p
    elif aps.aps_type == 1:  # LMCS
        aps.lmcs_min_bin_idx = r.ue()
        aps.lmcs_delta_max_bin_idx = r.ue()
        prec = r.ue() + 1
        max_bin = PIC_CODE_CW_BINS - 1 - aps.lmcs_delta_max_bin_idx
        deltas = [0] * PIC_CODE_CW_BINS
        for i in range(aps.lmcs_min_bin_idx, max_bin + 1):
            abs_cw = r.u(prec)
            sign = r.u(1) if abs_cw > 0 else 0
            deltas[i] = (1 - 2 * sign) * abs_cw
        aps.lmcs_cw = deltas
        abs_crs = r.u(3)
        sign = r.u(1) if abs_crs > 0 else 0
        aps.lmcs_delta_crs = (1 - 2 * sign) * abs_crs
    elif aps.aps_type == 2:  # scaling list (VLCReader parseScalingListAps)
        from vtm_tpu_torch.decoder import scaling_list as _scl

        aps.scaling_list = _scl.parse_scaling_list(r)
    if r.flag():
        while r.more_rbsp_data():
            r.flag()
    return aps


# ---------------------------------------------------------------------------
# picture header
# ---------------------------------------------------------------------------

def parse_picture_header(r: BitReader, psm: ParameterSetManager) -> PicHeader:
    ph = PicHeader()
    ph.gdr_or_irap = bool(r.flag())
    if ph.gdr_or_irap:
        ph.gdr_pic = bool(r.flag())
    ph.inter_slice_allowed = bool(r.flag())
    if ph.inter_slice_allowed:
        ph.intra_slice_allowed = bool(r.flag())
    else:
        ph.intra_slice_allowed = True
    ph.non_reference_picture = bool(r.flag())
    ph.pps_id = r.ue()
    pps = psm.pps[ph.pps_id]
    sps = psm.sps[pps.sps_id]
    ph.poc_lsb = r.u(sps.bits_for_poc)
    if ph.gdr_or_irap:
        ph.no_output_of_prior_pics = bool(r.flag())
    if ph.gdr_pic:
        ph.recovery_poc_cnt = r.ue()
    else:
        ph.recovery_poc_cnt = -1
    for i in range(8 * sps.num_extra_ph_bits):
        if sps.extra_ph_bit_present[i]:
            r.flag()
    if sps.poc_msb_flag:
        ph.poc_msb_present = bool(r.flag())
        if ph.poc_msb_present:
            ph.poc_msb_val = r.u(sps.poc_msb_len)
    # ALF
    if sps.alf:
        if pps.alf_info_in_ph:
            luma = bool(r.flag())
            ph.alf_enabled[0] = luma
            cb = cr = 0
            if luma:
                ph.num_alf_aps = r.u(3)
                ph.alf_aps_ids = [r.u(3) for _ in range(ph.num_alf_aps)]
                if sps.chroma_format_idc != 0:
                    cb = r.u(1)
                    cr = r.u(1)
                if cb or cr:
                    ph.alf_aps_id_chroma = r.u(3)
                if sps.ccalf:
                    ph.ccalf_enabled[0] = bool(r.flag())
                    if ph.ccalf_enabled[0]:
                        ph.ccalf_cb_aps_id = r.u(3)
                    ph.ccalf_enabled[1] = bool(r.flag())
                    if ph.ccalf_enabled[1]:
                        ph.ccalf_cr_aps_id = r.u(3)
            ph.alf_enabled[1] = bool(cb)
            ph.alf_enabled[2] = bool(cr)
        else:
            ph.alf_enabled = [True, True, True]
    # LMCS
    if sps.lmcs:
        ph.lmcs_enabled = bool(r.flag())
        if ph.lmcs_enabled:
            ph.lmcs_aps_id = r.u(2)
            if sps.chroma_format_idc != 0:
                ph.lmcs_chroma_residual_scale = bool(r.flag())
    if sps.explicit_scaling_list:
        ph.explicit_scaling_list_enabled = bool(r.flag())
        if ph.explicit_scaling_list_enabled:
            ph.scaling_list_aps_id = r.u(3)
    # PPS partitioning fixups happen here in the reference
    if (pps.pic_width == sps.max_pic_width and pps.pic_height == sps.max_pic_height):
        pps.conf_win = sps.conf_win
    derive_pps_partitioning(pps, sps)
    if sps.virtual_boundaries_enabled and not sps.virtual_boundaries_present:
        ph.virtual_boundaries_present = bool(r.flag())
        if ph.virtual_boundaries_present:
            ph.num_ver_vbs = r.u(2)
            ph.vb_pos_x = [r.ue() << 3 for _ in range(ph.num_ver_vbs)]
            ph.num_hor_vbs = r.u(2)
            ph.vb_pos_y = [r.ue() << 3 for _ in range(ph.num_hor_vbs)]
    else:
        ph.virtual_boundaries_present = sps.virtual_boundaries_present
        if ph.virtual_boundaries_present:
            ph.num_ver_vbs = sps.num_ver_vbs
            ph.num_hor_vbs = sps.num_hor_vbs
            ph.vb_pos_x = list(sps.vb_pos_x)
            ph.vb_pos_y = list(sps.vb_pos_y)
    if pps.output_flag_present and not ph.non_reference_picture:
        ph.pic_output = bool(r.flag())
    if pps.rpl_info_in_ph:
        _parse_ph_rpls(r, ph, sps, pps)
    if sps.partition_override_enabled:
        ph.split_cons_override = bool(r.flag())
    min_qt = [0, 0, 0]
    max_btd = [0, 0, 0]
    max_bt = [0, 0, 0]
    max_tt = [0, 0, 0]
    if ph.intra_slice_allowed:
        if ph.split_cons_override:
            min_qt[0] = 1 << (r.ue() + sps.log2_min_cb_size)
            max_btd[0] = r.ue()
            max_tt[0] = max_bt[0] = min_qt[0]
            if max_btd[0]:
                max_bt[0] <<= r.ue()
                max_tt[0] <<= r.ue()
            if sps.dual_i_tree:
                min_qt[2] = 1 << (r.ue() + sps.log2_min_cb_size)
                max_btd[2] = r.ue()
                max_tt[2] = max_bt[2] = min_qt[2]
                if max_btd[2]:
                    max_bt[2] <<= r.ue()
                    max_tt[2] <<= r.ue()
        if pps.cu_qp_delta_enabled:
            ph.cu_qp_delta_subdiv_intra = r.ue()
        if pps.chroma_qp_offset_list:
            ph.cu_chroma_qp_offset_subdiv_intra = r.ue()
    if ph.inter_slice_allowed:
        if ph.split_cons_override:
            min_qt[1] = 1 << (r.ue() + sps.log2_min_cb_size)
            max_btd[1] = r.ue()
            max_tt[1] = max_bt[1] = min_qt[1]
            if max_btd[1]:
                max_bt[1] <<= r.ue()
                max_tt[1] <<= r.ue()
        if pps.cu_qp_delta_enabled:
            ph.cu_qp_delta_subdiv_inter = r.ue()
        if pps.chroma_qp_offset_list:
            ph.cu_chroma_qp_offset_subdiv_inter = r.ue()
        if sps.temporal_mvp:
            ph.tmvp_enabled = bool(r.flag())
        if ph.tmvp_enabled and pps.rpl_info_in_ph:
            if ph.rpl[1].num_ref_entries > 0:
                ph.col_from_l0 = bool(r.u(1))
            else:
                ph.col_from_l0 = True
            if (ph.col_from_l0 and ph.rpl[0].num_ref_entries > 1) or (
                not ph.col_from_l0 and ph.rpl[1].num_ref_entries > 1
            ):
                ph.col_ref_idx = r.ue()
        else:
            ph.col_from_l0 = False
        if not pps.rpl_info_in_ph or ph.rpl[1].num_ref_entries > 0:
            ph.mvd_l1_zero = bool(r.flag())
        else:
            ph.mvd_l1_zero = True
        if sps.affine:
            ph.max_num_affine_merge_cand = sps.max_num_affine_merge_cand
        else:
            ph.max_num_affine_merge_cand = int(sps.sbtmvp and ph.tmvp_enabled)
        if sps.mmvd_fullpel_only:
            ph.dis_frac_mmvd = bool(r.flag())
        if sps.bdof_control_present and (
            not pps.rpl_info_in_ph or ph.rpl[1].num_ref_entries > 0
        ):
            ph.dis_bdof = bool(r.flag())
        else:
            ph.dis_bdof = (not sps.bdof) if not sps.bdof_control_present else True
        if sps.dmvr_control_present and (
            not pps.rpl_info_in_ph or ph.rpl[1].num_ref_entries > 0
        ):
            ph.dis_dmvr = bool(r.flag())
        else:
            ph.dis_dmvr = (not sps.dmvr) if not sps.dmvr_control_present else True
        if sps.prof_control_present:
            ph.dis_prof = bool(r.flag())
        else:
            ph.dis_prof = False
        if (pps.weighted_pred or pps.weighted_bipred) and pps.wp_info_in_ph:
            raise NotImplementedError("WP in PH not supported yet")
    if not sps.partition_override_enabled or not ph.split_cons_override:
        ph.min_qt_size = list(sps.min_qt_size)
        ph.max_mtt_depth = list(sps.max_mtt_depth)
        ph.max_bt_size = list(sps.max_bt_size)
        ph.max_tt_size = list(sps.max_tt_size)
    else:
        ph.min_qt_size, ph.max_mtt_depth = min_qt, max_btd
        ph.max_bt_size, ph.max_tt_size = max_bt, max_tt
    if pps.qp_delta_info_in_ph:
        ph.qp_delta = r.se()
    if sps.joint_cbcr:
        ph.joint_cbcr_sign = bool(r.flag())
    if sps.sao:
        if pps.sao_info_in_ph:
            ph.sao_enabled[0] = bool(r.flag())
            if sps.chroma_format_idc != 0:
                ph.sao_enabled[1] = bool(r.flag())
        else:
            ph.sao_enabled = [True, sps.chroma_format_idc != 0]
    if pps.deblocking_filter_control_present:
        if pps.deblocking_filter_override_enabled and pps.dbf_info_in_ph:
            ph.deblocking_override = bool(r.flag())
        if ph.deblocking_override:
            if not pps.deblocking_filter_disabled:
                ph.deblocking_disable = bool(r.flag())
            if not ph.deblocking_disable:
                ph.beta_offset_div2 = r.se()
                ph.tc_offset_div2 = r.se()
                if pps.chroma_tool_offsets_present:
                    ph.cb_beta_offset_div2 = r.se()
                    ph.cb_tc_offset_div2 = r.se()
                    ph.cr_beta_offset_div2 = r.se()
                    ph.cr_tc_offset_div2 = r.se()
                else:
                    ph.cb_beta_offset_div2 = ph.cr_beta_offset_div2 = ph.beta_offset_div2
                    ph.cb_tc_offset_div2 = ph.cr_tc_offset_div2 = ph.tc_offset_div2
        else:
            ph.deblocking_disable = pps.deblocking_filter_disabled
            ph.beta_offset_div2 = pps.beta_offset_div2
            ph.tc_offset_div2 = pps.tc_offset_div2
            ph.cb_beta_offset_div2 = pps.cb_beta_offset_div2
            ph.cb_tc_offset_div2 = pps.cb_tc_offset_div2
            ph.cr_beta_offset_div2 = pps.cr_beta_offset_div2
            ph.cr_tc_offset_div2 = pps.cr_tc_offset_div2
    if pps.picture_header_extension_present:
        n = r.ue()
        for _ in range(n):
            r.u(8)
    return ph


def _parse_ph_rpls(r: BitReader, ph: PicHeader, sps: SPS, pps: PPS) -> None:
    rpl_sps_flag0 = 0
    for list_idx in range(2):
        if sps.num_rpl(list_idx) > 0 and (list_idx == 0 or pps.rpl1_idx_present):
            code = r.flag()
        elif sps.num_rpl(list_idx) == 0:
            code = 0
        else:
            code = rpl_sps_flag0
        if list_idx == 0:
            rpl_sps_flag0 = code
        if not code:
            rpl = parse_ref_pic_list(r, sps, -1)
            ph.rpl_idx[list_idx] = -1
            ph.rpl[list_idx] = rpl
        else:
            if sps.num_rpl(list_idx) > 1 and (list_idx == 0 or pps.rpl1_idx_present):
                nbits = ceil_log2(sps.num_rpl(list_idx))
                idx = r.u(nbits)
            elif sps.num_rpl(list_idx) == 1:
                idx = 0
            else:
                idx = ph.rpl_idx[0]
            ph.rpl_idx[list_idx] = idx
            ph.rpl[list_idx] = sps.rpl_lists[list_idx][idx].copy()
        _parse_rpl_lt_extras(r, sps, ph.rpl[list_idx])


# ---------------------------------------------------------------------------
# slice header
# ---------------------------------------------------------------------------

def parse_slice_header(
    rbsp: bytes,
    nal_unit_type: int,
    temporal_id: int,
    psm: ParameterSetManager,
    ph: PicHeader | None,
    prev_tid0_poc: int,
) -> tuple[SliceHeader, PicHeader, BitReader]:
    """Parse a slice header; returns (sh, ph, reader positioned at slice data)."""
    r = BitReader(rbsp)
    sh = SliceHeader()
    sh.nal_unit_type = nal_unit_type
    sh.temporal_id = temporal_id
    sh.picture_header_in_slice_header = bool(r.flag())
    if sh.picture_header_in_slice_header:
        ph = parse_picture_header(r, psm)
    assert ph is not None, "no picture header before slice"
    pps = psm.pps[ph.pps_id]
    sps = psm.sps[pps.sps_id]
    chroma = sps.chroma_format_idc != 0
    # POC derivation (parseSliceHeader POC logic)
    poc_lsb = ph.poc_lsb
    max_poc_lsb = 1 << sps.bits_for_poc
    idr = nal_unit_type in (NAL_IDR_W_RADL, NAL_IDR_N_LP)
    if idr:
        poc_msb = ph.poc_msb_val * max_poc_lsb if ph.poc_msb_present else 0
    else:
        prev_lsb = prev_tid0_poc & (max_poc_lsb - 1)
        prev_msb = prev_tid0_poc - prev_lsb
        if ph.poc_msb_present:
            poc_msb = ph.poc_msb_val * max_poc_lsb
        elif poc_lsb < prev_lsb and prev_lsb - poc_lsb >= max_poc_lsb // 2:
            poc_msb = prev_msb + max_poc_lsb
        elif poc_lsb > prev_lsb and poc_lsb - prev_lsb > max_poc_lsb // 2:
            poc_msb = prev_msb - max_poc_lsb
        else:
            poc_msb = prev_msb
    sh.poc = poc_msb + poc_lsb
    if sps.num_subpics > 1:  # subpic_info_present → id signalled
        sh.subpic_id = r.u(sps.subpic_id_len)
    pic_w_ctu = pps.pic_width_in_ctu(1 << pps.log2_ctu_size)
    if not pps.rect_slice:
        if pps.num_tiles > 1:
            bits = ceil_log2(pps.num_tiles)
            slice_addr = r.u(bits)
            if pps.num_tiles - slice_addr > 1:
                num_tiles_in_slice = r.ue() + 1
            else:
                num_tiles_in_slice = 1
        else:
            slice_addr, num_tiles_in_slice = 0, 1
        sh.slice_id = slice_addr
        sh.ctu_addrs = []
        for t in range(slice_addr, slice_addr + num_tiles_in_slice):
            tx = t % pps.num_tile_cols
            ty = t // pps.num_tile_cols
            sh.ctu_addrs += _ctus_in_rect(
                pps.tile_col_bd[tx], pps.tile_col_bd[tx + 1],
                pps.tile_row_bd[ty], pps.tile_row_bd[ty + 1], pic_w_ctu
            )
    else:
        sub_idx = (
            sps.subpic_ids.index(sh.subpic_id)
            if sps.num_subpics > 1 else 0
        )
        if pps.single_slice_per_subpic and sps.num_subpics > 1:
            num_slices_in_subpic = 1
        else:
            # count slices within this subpic via slice maps
            num_slices_in_subpic = pps.num_slices_in_pic if sps.num_subpics == 1 else 1
        if sps.num_subpics > 1 and not pps.single_slice_per_subpic:
            raise NotImplementedError("multi-slice subpictures not supported yet")
        if num_slices_in_subpic > 1:
            bits = ceil_log2(num_slices_in_subpic)
            slice_addr = r.u(bits)
        else:
            slice_addr = 0
        pic_level_idx = slice_addr
        for sp in range(sub_idx):
            pic_level_idx += 1  # single slice per preceding subpic
        sh.slice_id = pic_level_idx
        sh.ctu_addrs = list(pps.slice_ctu_addrs[pic_level_idx])
    for i in range(8 * sps.num_extra_sh_bits):
        if sps.extra_sh_bit_present[i]:
            r.flag()
    if ph.inter_slice_allowed:
        sh.slice_type = SliceType(r.ue())
    else:
        sh.slice_type = SliceType.I
    # inherit from picture header
    sh.cb_qp_offset = pps.cb_qp_offset
    sh.cr_qp_offset = pps.cr_qp_offset
    sh.joint_cbcr_qp_offset = pps.joint_cbcr_qp_offset
    sh.deblocking_disable = ph.deblocking_disable
    sh.beta_offset_div2 = ph.beta_offset_div2
    sh.tc_offset_div2 = ph.tc_offset_div2
    sh.cb_beta_offset_div2 = ph.cb_beta_offset_div2
    sh.cb_tc_offset_div2 = ph.cb_tc_offset_div2
    sh.cr_beta_offset_div2 = ph.cr_beta_offset_div2
    sh.cr_tc_offset_div2 = ph.cr_tc_offset_div2
    sh.sao_enabled = list(ph.sao_enabled)
    sh.alf_enabled = list(ph.alf_enabled)
    sh.num_alf_aps = ph.num_alf_aps
    sh.alf_aps_ids = list(ph.alf_aps_ids)
    sh.alf_aps_id_chroma = ph.alf_aps_id_chroma
    sh.ccalf_cb_enabled = ph.ccalf_enabled[0]
    sh.ccalf_cr_enabled = ph.ccalf_enabled[1]
    sh.ccalf_cb_aps_id = ph.ccalf_cb_aps_id
    sh.ccalf_cr_aps_id = ph.ccalf_cr_aps_id
    if sps.alf and not pps.alf_info_in_ph:
        luma = bool(r.flag())
        sh.alf_enabled[0] = luma
        cb = cr = 0
        if luma:
            sh.num_alf_aps = r.u(3)
            sh.alf_aps_ids = [r.u(3) for _ in range(sh.num_alf_aps)]
            if chroma:
                cb = r.u(1)
                cr = r.u(1)
            if cb or cr:
                sh.alf_aps_id_chroma = r.u(3)
            if sps.ccalf:
                sh.ccalf_cb_enabled = bool(r.flag())
                if sh.ccalf_cb_enabled:
                    sh.ccalf_cb_aps_id = r.u(3)
                sh.ccalf_cr_enabled = bool(r.flag())
                if sh.ccalf_cr_enabled:
                    sh.ccalf_cr_aps_id = r.u(3)
        else:
            sh.num_alf_aps = 0
        sh.alf_enabled[1] = bool(cb)
        sh.alf_enabled[2] = bool(cr)
    if ph.lmcs_enabled and not sh.picture_header_in_slice_header:
        sh.lmcs_enabled = bool(r.flag())
    else:
        sh.lmcs_enabled = ph.lmcs_enabled if sh.picture_header_in_slice_header else False
    if ph.explicit_scaling_list_enabled and not sh.picture_header_in_slice_header:
        sh.explicit_scaling_list_used = bool(r.flag())
    else:
        sh.explicit_scaling_list_used = (
            ph.explicit_scaling_list_enabled if sh.picture_header_in_slice_header else False
        )
    if sps.separate_colour_plane:
        sh.colour_plane_id = r.u(2)
    # RPLs
    if pps.rpl_info_in_ph:
        sh.rpl = [ph.rpl[0], ph.rpl[1]]
    elif idr and not sps.idr_rpl_present:
        sh.rpl = [RefPicList(), RefPicList()]
    else:
        rpl_sps_flag0 = 0
        for list_idx in range(2):
            if list_idx == 0:
                code = r.flag() if sps.num_rpl(0) > 0 else 0
                rpl_sps_flag0 = code
            else:
                if sps.num_rpl(1) > 0 and pps.rpl1_idx_present:
                    code = r.flag()
                elif sps.num_rpl(1) == 0:
                    code = 0
                else:
                    code = rpl_sps_flag0
            if not code:
                rpl = parse_ref_pic_list(r, sps, -1)
                sh.rpl_idx[list_idx] = -1
                sh.rpl[list_idx] = rpl
            else:
                if sps.num_rpl(list_idx) > 1 and (list_idx == 0 or pps.rpl1_idx_present):
                    idx = r.u(ceil_log2(sps.num_rpl(list_idx)))
                elif sps.num_rpl(list_idx) == 1:
                    idx = 0
                else:
                    idx = sh.rpl_idx[0]
                sh.rpl_idx[list_idx] = idx
                sh.rpl[list_idx] = sps.rpl_lists[list_idx][idx].copy()
            _parse_rpl_lt_extras(r, sps, sh.rpl[list_idx])
    # num_ref_idx_active
    if not pps.rpl_info_in_ph and idr and not sps.idr_rpl_present:
        sh.num_ref_idx = [0, 0]
    if (not sh.is_intra and sh.rpl[0].num_ref_entries > 1) or (
        sh.is_b and sh.rpl[1].num_ref_entries > 1
    ):
        if r.flag():  # override
            n0 = (r.ue() if sh.rpl[0].num_ref_entries > 1 else 0) + 1
            sh.num_ref_idx[0] = n0
            if sh.is_b:
                n1 = (r.ue() if sh.rpl[1].num_ref_entries > 1 else 0) + 1
                sh.num_ref_idx[1] = n1
            else:
                sh.num_ref_idx[1] = 0
        else:
            sh.num_ref_idx[0] = min(sh.rpl[0].num_ref_entries, pps.num_ref_idx_default[0])
            sh.num_ref_idx[1] = (
                min(sh.rpl[1].num_ref_entries, pps.num_ref_idx_default[1]) if sh.is_b else 0
            )
    else:
        sh.num_ref_idx[0] = 0 if sh.is_intra else 1
        sh.num_ref_idx[1] = 1 if sh.is_b else 0
    sh.cabac_init_flag = False
    if pps.cabac_init_present and not sh.is_intra:
        sh.cabac_init_flag = bool(r.flag())
    if ph.tmvp_enabled:
        if sh.slice_type == SliceType.P:
            sh.col_from_l0 = True
        elif not pps.rpl_info_in_ph and sh.is_b:
            sh.col_from_l0 = bool(r.flag())
        else:
            sh.col_from_l0 = ph.col_from_l0
        if not pps.rpl_info_in_ph:
            if not sh.is_intra and (
                (sh.col_from_l0 and sh.num_ref_idx[0] > 1)
                or (not sh.col_from_l0 and sh.num_ref_idx[1] > 1)
            ):
                sh.col_ref_idx = r.ue()
            else:
                sh.col_ref_idx = 0
        else:
            sh.col_ref_idx = ph.col_ref_idx
    if (pps.weighted_pred and sh.slice_type == SliceType.P) or (
        pps.weighted_bipred and sh.is_b
    ):
        if pps.wp_info_in_ph:
            raise NotImplementedError("WP in PH")
        sh.wp_scaling = parse_pred_weight_table(r, sps, sh)
    # QP
    qp_delta = ph.qp_delta if pps.qp_delta_info_in_ph else r.se()
    sh.qp = 26 + (pps.init_qp - 26) + qp_delta
    if pps.slice_chroma_qp_flag:
        if chroma:
            sh.cb_qp_offset = pps.cb_qp_offset + r.se()
            sh.cr_qp_offset = pps.cr_qp_offset + r.se()
            if sps.joint_cbcr:
                sh.joint_cbcr_qp_offset = pps.joint_cbcr_qp_offset + r.se()
    if pps.chroma_qp_offset_list:
        sh.use_chroma_qp_adj = bool(r.flag())
    if sps.sao and not pps.sao_info_in_ph:
        sh.sao_enabled[0] = bool(r.flag())
        if chroma:
            sh.sao_enabled[1] = bool(r.flag())
    if pps.deblocking_filter_control_present:
        if pps.deblocking_filter_override_enabled and not pps.dbf_info_in_ph:
            sh.deblocking_override = bool(r.flag())
        if sh.deblocking_override:
            if not pps.deblocking_filter_disabled:
                sh.deblocking_disable = bool(r.flag())
            else:
                sh.deblocking_disable = False
            if not sh.deblocking_disable:
                sh.beta_offset_div2 = r.se()
                sh.tc_offset_div2 = r.se()
                if pps.chroma_tool_offsets_present:
                    sh.cb_beta_offset_div2 = r.se()
                    sh.cb_tc_offset_div2 = r.se()
                    sh.cr_beta_offset_div2 = r.se()
                    sh.cr_tc_offset_div2 = r.se()
                else:
                    sh.cb_beta_offset_div2 = sh.cr_beta_offset_div2 = sh.beta_offset_div2
                    sh.cb_tc_offset_div2 = sh.cr_tc_offset_div2 = sh.tc_offset_div2
    if sps.dep_quant:
        sh.dep_quant = bool(r.flag())
    if sps.sign_data_hiding and not sh.dep_quant:
        sh.sign_data_hiding = bool(r.flag())
    if sps.transform_skip and not sh.dep_quant and not sh.sign_data_hiding:
        sh.ts_residual_coding_disabled = bool(r.flag())
    if pps.slice_header_extension_present:
        n = r.ue()
        for _ in range(n):
            r.u(8)
    # entry points
    num_entry_points = _num_entry_points(sh, sps, pps)
    if num_entry_points > 0:
        offset_len = r.ue() + 1
        sh.entry_point_offsets = [r.u(offset_len) + 1 for _ in range(num_entry_points)]
    # byte alignment before slice data
    align_bit = r.u(1)
    while not r.byte_aligned():
        r.u(1)
    return sh, ph, r


def _num_entry_points(sh: SliceHeader, sps: SPS, pps: PPS) -> int:
    """Ref: Slice::setNumEntryPoints — substream boundaries at tile changes
    and (with WPP) CTU-row changes."""
    if not sps.entry_point_offsets_present:
        return 0
    pic_w_ctu = pps.pic_width_in_ctu(1 << pps.log2_ctu_size)
    n = 0
    prev = None
    for addr in sh.ctu_addrs:
        x = addr % pic_w_ctu
        y = addr // pic_w_ctu
        key = (
            pps.ctu_to_tile_col[x],
            pps.ctu_to_tile_row[y],
            y if sps.entropy_coding_sync else 0,
        )
        if prev is not None and key != prev:
            n += 1
        prev = key
    return n


def parse_pred_weight_table(r: BitReader, sps: SPS, sh: SliceHeader):
    """Slice-header weighted prediction table (parsePredWeightTable:4448).

    Returns wp[list][ref][comp] = {present, w, o, denom} with the weight/
    offset reconstruction applied (VLCReader.cpp:4518-4559)."""
    chroma = sps.chroma_format_idc != 0
    denom_y = r.ue()
    denom_c = denom_y + r.se() if chroma else 0
    out = []
    for list_idx in range(2 if sh.is_b else 1):
        n = sh.num_ref_idx[list_idx]
        luma_flags = [bool(r.flag()) for _ in range(n)]
        chroma_flags = [bool(r.flag()) for _ in range(n)] if chroma else [False] * n
        entries = []
        for i in range(n):
            comps = []
            if luma_flags[i]:
                dw = r.se()
                off = r.se()
                comps.append({"present": True, "w": dw + (1 << denom_y),
                              "o": off, "denom": denom_y})
            else:
                comps.append({"present": False, "w": 1 << denom_y, "o": 0,
                              "denom": denom_y})
            for _c in range(2):
                if chroma_flags[i]:
                    dw = r.se()
                    doff = r.se()
                    w = dw + (1 << denom_c)
                    rng = 128
                    pred = rng - ((rng * w) >> denom_c)
                    o = max(-rng, min(rng - 1, doff + pred))
                    comps.append({"present": True, "w": w, "o": o,
                                  "denom": denom_c})
                elif chroma:
                    comps.append({"present": False, "w": 1 << denom_c,
                                  "o": 0, "denom": denom_c})
                else:
                    comps.append({"present": False, "w": 1, "o": 0, "denom": 0})
            entries.append(comps)
        out.append(entries)
    if len(out) == 1:
        out.append([])
    return out
