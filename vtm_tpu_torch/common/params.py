"""High-level parameter sets: SPS / PPS / APS / PicHeader / SliceHeader.

Plain dataclasses mirroring the VVC spec syntax (reference: Slice.h:891-2507,
VLCReader.cpp parseSPS:1277 / parsePPS:413 / parsePictureHeader:2318 /
parseSliceHeader:3214).  Only state, no behavior — derivation helpers live
in vtm_tpu_torch.decoder.vlc and the picture pipeline.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from vtm_tpu_torch.common.types import ChromaFormat, SliceType


@dataclass
class RefPicList:
    """One candidate reference picture list (spec ref_pic_list_struct)."""

    num_ref_entries: int = 0
    ltrp_in_slice_header: bool = True
    # per-entry: (identifier, is_longterm, is_interlayer)
    identifiers: list[int] = field(default_factory=list)
    is_longterm: list[bool] = field(default_factory=list)
    is_interlayer: list[bool] = field(default_factory=list)
    interlayer_idx: list[int] = field(default_factory=list)
    num_strp: int = 0
    num_ltrp: int = 0
    num_ilrp: int = 0
    # slice/PH-level long-term POC extras
    delta_poc_msb_present: list[bool] = field(default_factory=list)
    delta_poc_msb_cycle: list[int] = field(default_factory=list)

    def copy(self) -> "RefPicList":
        import copy

        return copy.deepcopy(self)


@dataclass
class ChromaQpTable:
    """Derived chroma QP mapping tables (one per cIdx-1 or shared)."""

    tables: list[list[int]] = field(default_factory=list)  # [i][qp + qp_bd_offset]

    def map_qp(self, table_idx: int, qp: int, qp_bd_offset: int) -> int:
        return self.tables[min(table_idx, len(self.tables) - 1)][qp + qp_bd_offset]


@dataclass
class SPS:
    sps_id: int = 0
    vps_id: int = 0
    max_sub_layers: int = 1
    gdr_enabled: bool = False
    chroma_format_idc: int = 1
    separate_colour_plane: bool = False
    ref_pic_resampling: bool = False
    res_change_in_clvs: bool = False
    max_pic_width: int = 0
    max_pic_height: int = 0
    conf_win: tuple[int, int, int, int] = (0, 0, 0, 0)  # l, r, t, b
    ctu_size: int = 128
    log2_ctu_size: int = 7
    # subpics
    num_subpics: int = 1
    independent_subpics: bool = True
    subpic_ctu_top_left: list[tuple[int, int]] = field(default_factory=list)
    subpic_size_ctus: list[tuple[int, int]] = field(default_factory=list)
    subpic_treated_as_pic: list[bool] = field(default_factory=list)
    loop_filter_across_subpic: list[bool] = field(default_factory=list)
    subpic_id_len: int = 16
    subpic_id_mapping_explicit: bool = False
    subpic_id_mapping_in_sps: bool = False
    subpic_ids: list[int] = field(default_factory=list)
    bit_depth: int = 8  # luma == chroma in VVC
    qp_bd_offset: int = 0
    entropy_coding_sync: bool = False  # WPP
    entry_point_offsets_present: bool = False
    bits_for_poc: int = 8
    poc_msb_flag: bool = False
    poc_msb_len: int = 1
    num_extra_ph_bits: int = 0
    extra_ph_bit_present: list[bool] = field(default_factory=list)
    num_extra_sh_bits: int = 0
    extra_sh_bit_present: list[bool] = field(default_factory=list)
    ptl_dpb_hrd_present: bool = True
    sublayer_dpb_params: bool = False
    max_dec_pic_buffering: list[int] = field(default_factory=lambda: [1])
    num_reorder_pics: list[int] = field(default_factory=lambda: [0])
    dual_i_tree: bool = False
    log2_min_cb_size: int = 2
    partition_override_enabled: bool = False
    # partition limits [0]=intra luma, [1]=inter, [2]=intra chroma
    min_qt_size: list[int] = field(default_factory=lambda: [0, 0, 0])
    max_mtt_depth: list[int] = field(default_factory=lambda: [0, 0, 0])
    max_bt_size: list[int] = field(default_factory=lambda: [0, 0, 0])
    max_tt_size: list[int] = field(default_factory=lambda: [0, 0, 0])
    max_tb_size_64: bool = False
    log2_max_tb_size: int = 5
    # chroma qp
    joint_cbcr: bool = False
    same_qp_table_for_chroma: bool = True
    chroma_qp_table: ChromaQpTable = field(default_factory=ChromaQpTable)
    sao: bool = False
    alf: bool = False
    ccalf: bool = False
    transform_skip: bool = False
    log2_max_ts_size: int = 2
    bdpcm: bool = False
    weighted_pred: bool = False
    weighted_bipred: bool = False
    long_term_ref_pics: bool = False
    inter_layer_ref_pics: bool = False
    idr_rpl_present: bool = False
    rpl1_copy_from_rpl0: bool = False
    rpl_lists: tuple[list[RefPicList], list[RefPicList]] = field(
        default_factory=lambda: ([], [])
    )
    ref_wraparound: bool = False
    temporal_mvp: bool = False
    sbtmvp: bool = False
    amvr: bool = False
    bdof: bool = False
    bdof_control_present: bool = False
    smvd: bool = False
    dmvr: bool = False
    dmvr_control_present: bool = False
    mmvd: bool = False
    mmvd_fullpel_only: bool = False
    max_num_merge_cand: int = 5
    sbt: bool = False
    affine: bool = False
    max_num_affine_merge_cand: int = 5
    affine_type: bool = False
    affine_amvr: bool = False
    prof: bool = False
    prof_control_present: bool = False
    bcw: bool = False
    ciip: bool = False
    geo: bool = False
    max_num_geo_cand: int = 0
    log2_parallel_merge_level: int = 2
    isp: bool = False
    mrl: bool = False
    mip: bool = False
    cclm: bool = False
    chroma_hor_collocated: bool = True
    chroma_ver_collocated: bool = True
    mts: bool = False
    explicit_mts_intra: bool = False
    explicit_mts_inter: bool = False
    palette: bool = False
    act: bool = False
    internal_minus_input_bd: int = 0
    ibc: bool = False
    max_num_ibc_merge_cand: int = 0
    lmcs: bool = False
    lfnst: bool = False
    ladf: bool = False
    explicit_scaling_list: bool = False
    scaling_matrix_for_lfnst_disabled: bool = False
    dep_quant: bool = False
    sign_data_hiding: bool = False
    virtual_boundaries_enabled: bool = False
    virtual_boundaries_present: bool = False
    num_ver_vbs: int = 0
    num_hor_vbs: int = 0
    vb_pos_x: list[int] = field(default_factory=list)
    vb_pos_y: list[int] = field(default_factory=list)
    field_seq: bool = False
    general_hrd: dict | None = None  # general_hrd_parameters()
    ols_hrd: list | None = None  # per-sublayer ols_hrd_parameters()
    vui: dict | None = None  # vui_parameters()
    # profile/level
    profile_idc: int = 0
    level_idc: int = 0

    @property
    def chroma_format(self) -> ChromaFormat:
        return ChromaFormat(self.chroma_format_idc)

    @property
    def max_log2_tr_dynamic_range(self) -> int:
        return 15  # extended precision unsupported

    def num_rpl(self, list_idx: int) -> int:
        return len(self.rpl_lists[list_idx])


@dataclass
class PPS:
    pps_id: int = 0
    sps_id: int = 0
    mixed_nalu_types: bool = False
    pic_width: int = 0
    pic_height: int = 0
    conf_win: tuple[int, int, int, int] = (0, 0, 0, 0)
    scaling_win: tuple[int, int, int, int] = (0, 0, 0, 0)
    output_flag_present: bool = False
    no_pic_partition: bool = True
    subpic_id_mapping_in_pps: bool = False
    num_subpics: int = 1
    subpic_id_len: int = 0
    subpic_ids: list[int] = field(default_factory=list)
    log2_ctu_size: int = 7
    # tiles (derived)
    num_exp_tile_cols: int = 1
    num_exp_tile_rows: int = 1
    tile_col_widths: list[int] = field(default_factory=list)  # expanded, CTUs
    tile_row_heights: list[int] = field(default_factory=list)
    tile_col_bd: list[int] = field(default_factory=list)  # boundaries, CTUs
    tile_row_bd: list[int] = field(default_factory=list)
    ctu_to_tile_col: list[int] = field(default_factory=list)
    ctu_to_tile_row: list[int] = field(default_factory=list)
    loop_filter_across_tiles: bool = True
    rect_slice: bool = True
    single_slice_per_subpic: bool = True
    num_slices_in_pic: int = 1
    tile_idx_delta_present: bool = False
    slice_tile_idx: list[int] = field(default_factory=list)
    slice_width_in_tiles: list[int] = field(default_factory=list)
    slice_height_in_tiles: list[int] = field(default_factory=list)
    num_slices_in_tile: list[int] = field(default_factory=list)
    slice_height_in_ctu: list[int] = field(default_factory=list)
    loop_filter_across_slices: bool = False
    # per-slice CTU address maps, filled by init_slice_maps
    slice_ctu_addrs: list[list[int]] = field(default_factory=list)
    cabac_init_present: bool = False
    num_ref_idx_default: tuple[int, int] = (1, 1)
    rpl1_idx_present: bool = False
    init_qp: int = 26
    cu_qp_delta_enabled: bool = False
    chroma_tool_offsets_present: bool = False
    cb_qp_offset: int = 0
    cr_qp_offset: int = 0
    joint_cbcr_qp_offset_present: bool = False
    joint_cbcr_qp_offset: int = 0
    slice_chroma_qp_flag: bool = False
    chroma_qp_offset_list: list[tuple[int, int, int]] = field(default_factory=list)
    weighted_pred: bool = False
    weighted_bipred: bool = False
    deblocking_filter_control_present: bool = False
    deblocking_filter_override_enabled: bool = False
    deblocking_filter_disabled: bool = False
    dbf_info_in_ph: bool = False
    beta_offset_div2: int = 0
    tc_offset_div2: int = 0
    cb_beta_offset_div2: int = 0
    cb_tc_offset_div2: int = 0
    cr_beta_offset_div2: int = 0
    cr_tc_offset_div2: int = 0
    rpl_info_in_ph: bool = False
    sao_info_in_ph: bool = False
    alf_info_in_ph: bool = False
    wp_info_in_ph: bool = False
    qp_delta_info_in_ph: bool = False
    wraparound: bool = False
    pic_width_minus_wraparound_offset: int = 0
    wraparound_offset: int = 0
    picture_header_extension_present: bool = False
    slice_header_extension_present: bool = False

    def pic_width_in_ctu(self, ctu_size: int) -> int:
        return (self.pic_width + ctu_size - 1) // ctu_size

    def pic_height_in_ctu(self, ctu_size: int) -> int:
        return (self.pic_height + ctu_size - 1) // ctu_size

    @property
    def num_tiles(self) -> int:
        return len(self.tile_col_widths) * len(self.tile_row_heights)

    @property
    def num_tile_cols(self) -> int:
        return len(self.tile_col_widths)

    @property
    def num_tile_rows(self) -> int:
        return len(self.tile_row_heights)


@dataclass
class APS:
    aps_id: int = 0
    aps_type: int = 0  # 0=ALF, 1=LMCS, 2=scaling list
    # LMCS payload
    lmcs_min_bin_idx: int = 0
    lmcs_delta_max_bin_idx: int = 0
    lmcs_cw: list[int] = field(default_factory=lambda: [0] * 16)
    lmcs_delta_crs: int = 0
    # ALF payload (set by vlc.parse_alf_aps)
    alf: "object" = None
    # scaling list payload
    scaling_list: "object" = None


@dataclass
class PicHeader:
    gdr_or_irap: bool = False
    gdr_pic: bool = False
    inter_slice_allowed: bool = True
    intra_slice_allowed: bool = True
    non_reference_picture: bool = False
    pps_id: int = 0
    poc_lsb: int = 0
    no_output_of_prior_pics: bool = False
    recovery_poc_cnt: int = -1
    poc_msb_present: bool = False
    poc_msb_val: int = 0
    # ALF
    alf_enabled: list[bool] = field(default_factory=lambda: [False] * 3)
    num_alf_aps: int = 0
    alf_aps_ids: list[int] = field(default_factory=list)
    alf_aps_id_chroma: int = 0
    ccalf_enabled: list[bool] = field(default_factory=lambda: [False, False])  # cb, cr
    ccalf_cb_aps_id: int = -1
    ccalf_cr_aps_id: int = -1
    # LMCS
    lmcs_enabled: bool = False
    lmcs_aps_id: int = 0
    lmcs_chroma_residual_scale: bool = False
    explicit_scaling_list_enabled: bool = False
    scaling_list_aps_id: int = 0
    virtual_boundaries_present: bool = False
    num_ver_vbs: int = 0
    num_hor_vbs: int = 0
    vb_pos_x: list[int] = field(default_factory=list)
    vb_pos_y: list[int] = field(default_factory=list)
    pic_output: bool = True
    rpl_idx: list[int] = field(default_factory=lambda: [-1, -1])
    rpl: list[RefPicList | None] = field(default_factory=lambda: [None, None])
    split_cons_override: bool = False
    min_qt_size: list[int] = field(default_factory=lambda: [0, 0, 0])
    max_mtt_depth: list[int] = field(default_factory=lambda: [0, 0, 0])
    max_bt_size: list[int] = field(default_factory=lambda: [0, 0, 0])
    max_tt_size: list[int] = field(default_factory=lambda: [0, 0, 0])
    cu_qp_delta_subdiv_intra: int = 0
    cu_chroma_qp_offset_subdiv_intra: int = 0
    cu_qp_delta_subdiv_inter: int = 0
    cu_chroma_qp_offset_subdiv_inter: int = 0
    tmvp_enabled: bool = False
    col_from_l0: bool = False
    col_ref_idx: int = 0
    mvd_l1_zero: bool = True
    max_num_affine_merge_cand: int = 0
    dis_frac_mmvd: bool = False
    dis_bdof: bool = True
    dis_dmvr: bool = True
    dis_prof: bool = True
    qp_delta: int = 0
    joint_cbcr_sign: bool = False
    sao_enabled: list[bool] = field(default_factory=lambda: [False, False])  # luma, chroma
    deblocking_override: bool = False
    deblocking_disable: bool = False
    beta_offset_div2: int = 0
    tc_offset_div2: int = 0
    cb_beta_offset_div2: int = 0
    cb_tc_offset_div2: int = 0
    cr_beta_offset_div2: int = 0
    cr_tc_offset_div2: int = 0


@dataclass
class SliceHeader:
    picture_header_in_slice_header: bool = False
    poc: int = 0
    subpic_id: int = 0
    slice_id: int = 0
    ctu_addrs: list[int] = field(default_factory=list)  # raster CTU addresses
    slice_type: SliceType = SliceType.I
    # ALF
    alf_enabled: list[bool] = field(default_factory=lambda: [False] * 3)
    num_alf_aps: int = 0
    alf_aps_ids: list[int] = field(default_factory=list)
    alf_aps_id_chroma: int = 0
    ccalf_cb_enabled: bool = False
    ccalf_cr_enabled: bool = False
    ccalf_cb_aps_id: int = -1
    ccalf_cr_aps_id: int = -1
    lmcs_enabled: bool = False
    explicit_scaling_list_used: bool = False
    colour_plane_id: int = 0
    rpl: list[RefPicList | None] = field(default_factory=lambda: [None, None])
    rpl_idx: list[int] = field(default_factory=lambda: [-1, -1])
    num_ref_idx: list[int] = field(default_factory=lambda: [0, 0])
    cabac_init_flag: bool = False
    col_from_l0: bool = True
    col_ref_idx: int = 0
    wp_scaling: "object" = None
    qp: int = 26
    cb_qp_offset: int = 0
    cr_qp_offset: int = 0
    joint_cbcr_qp_offset: int = 0
    use_chroma_qp_adj: bool = False
    sao_enabled: list[bool] = field(default_factory=lambda: [False, False])
    deblocking_override: bool = False
    deblocking_disable: bool = False
    beta_offset_div2: int = 0
    tc_offset_div2: int = 0
    cb_beta_offset_div2: int = 0
    cb_tc_offset_div2: int = 0
    cr_beta_offset_div2: int = 0
    cr_tc_offset_div2: int = 0
    dep_quant: bool = False
    sign_data_hiding: bool = False
    ts_residual_coding_disabled: bool = False
    entry_point_offsets: list[int] = field(default_factory=list)
    # for reference management
    nal_unit_type: int = 0
    temporal_id: int = 0
    # ---- runtime state derived at slice activation (not parsed) ----
    independent_slice_idx: int = 0
    ref_pics: list = field(default_factory=lambda: [[], []])  # Picture refs
    ref_pocs: list = field(default_factory=lambda: [[], []])
    ref_longterm: list = field(default_factory=lambda: [[], []])
    check_ldc: bool = False
    bi_dir_pred: bool = False
    sym_ref_idx: list[int] = field(default_factory=lambda: [-1, -1])
    temporal_mvp: bool = False

    def wp_present(self, ref_idx) -> bool:
        """True if explicit WP weights are present for either used ref
        (CU::isBcwIdxCoded check)."""
        if self.wp_scaling is None:
            return False
        for lst in range(2):
            ri = ref_idx[lst]
            if ri is None or ri < 0:
                continue
            if ri >= len(self.wp_scaling[lst]):
                continue
            for comp_wp in self.wp_scaling[lst][ri]:
                if comp_wp["present"]:
                    return True
        return False

    @property
    def is_intra(self) -> bool:
        return self.slice_type == SliceType.I

    @property
    def is_b(self) -> bool:
        return self.slice_type == SliceType.B

    @property
    def is_p(self) -> bool:
        return self.slice_type == SliceType.P
