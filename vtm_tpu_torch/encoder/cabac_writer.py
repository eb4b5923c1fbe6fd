"""CTU-level CABAC syntax writing (v1 intra feature set).

Mirror of EncoderLib/CABACWriter.cpp for the encoder's current toolset
(single tree, QT-only or QTBT, 67-mode intra, DCT2, no secondary tools).
Context derivations are shared with the decoder's SyntaxReader so the
encoder and decoder stay bin-exact by construction.  The `engine` is
either a BinEncoder (real bits) or BitEstimator (RD search).
"""

from __future__ import annotations

import numpy as np

from vtm_tpu_torch.common import rom
from vtm_tpu_torch.decoder import cs as D
from vtm_tpu_torch.decoder import partitioner as P
from vtm_tpu_torch.decoder.cabac_reader import (
    CoeffCtx,
    CuCtx,
    NUM_MPM,
    SyntaxReader,
    ctx,
    _GROUP_IDX,
    _MIN_IN_GROUP,
    _GO_RICE_PARS,
    COEF_REMAIN_BIN_REDUCTION,
    MAX_CTX_BIN_RATIO_LUMA,
    MAX_CTX_BIN_RATIO_CHROMA,
)
from vtm_tpu_torch.decoder.cs import CH_C, CH_L, CU, MODE_INTRA, TU

_NATIVE_EST = None  # None = not probed; False = unavailable


def _native_est():
    """The C residual-coding bit estimator (native/cabac.c rc_est)."""
    global _NATIVE_EST
    if _NATIVE_EST is None:
        from vtm_tpu_torch.native import load_cabac

        mod = load_cabac()
        if mod is not None and hasattr(mod, "rc_est"):
            mod.set_tables(
                np.ascontiguousarray(rom.group_idx(), dtype=np.int32),
                np.ascontiguousarray(rom.min_in_group(), dtype=np.int32),
                np.ascontiguousarray(rom.go_rice_pars_coeff(), dtype=np.int32),
            )
            mod.set_frac_table(
                np.ascontiguousarray(rom.bin_frac_bits(), dtype=np.int64))
            _NATIVE_EST = mod
        else:
            _NATIVE_EST = False
    return _NATIVE_EST


class SyntaxWriter:
    def __init__(self, dcs, engine):
        self.cs = dcs
        self.e = engine
        self.sps = dcs.sps
        self.pps = dcs.pps
        self.helper = SyntaxReader(dcs, None)  # ctx derivations only

    # ------------------------------------------------------------------
    def coding_tree_unit(self, ctu_rect, ctus_cus):
        """Write the chosen coding tree for one CTU (cus already in cs)."""
        part = P.Partitioner(self.cs)
        part.init_ctu(ctu_rect, CH_L)
        cu_ctx = CuCtx(0)
        self.coding_tree(part, cu_ctx)

    def sao(self, ctu_rect, params):
        """Mirror of CABACReader.sao (sao parameter writing per CTU)."""
        sps = self.sps
        sh = self.cs.sh
        if not sps.sao:
            return
        luma_on = sh.sao_enabled[0]
        chroma_on = sh.sao_enabled[1] and sps.chroma_format_idc != 0
        if not luma_on and not chroma_on:
            return
        ctu = sps.ctu_size
        left = self.cs.get_cu_restricted(
            ctu_rect.x - ctu, ctu_rect.y, ctu_rect.x, ctu_rect.y, CH_L)
        above = self.cs.get_cu_restricted(
            ctu_rect.x, ctu_rect.y - ctu, ctu_rect.x, ctu_rect.y, CH_L)
        merged = params.mode[0] == 2
        merge_type = params.type_idc[0] if merged else -1
        if left is not None:
            self.e.encode_bin(int(merged and merge_type == 0), ctx("SaoMergeFlag"))
            if merged and merge_type == 0:
                return
        if above is not None:
            self.e.encode_bin(int(merged and merge_type == 1), ctx("SaoMergeFlag"))
            if merged and merge_type == 1:
                return
        first = 0 if luma_on else 1
        last = 2 if chroma_on else 0
        max_offset = min((1 << (min(sps.bit_depth, 10) - 5)) - 1, 31)
        for comp in range(first, last + 1):
            if comp != 2:
                on = params.mode[comp] != 0
                self.e.encode_bin(int(on), ctx("SaoTypeIdx"))
                if on:
                    self.e.encode_bin_ep(int(params.type_idc[comp] != 4))
            if params.mode[comp] == 0:
                continue
            is_bo = params.type_idc[comp] == 4
            if is_bo:
                offs = [params.offsets[comp][(params.type_aux[comp] + k) % 32]
                        for k in range(4)]
            else:
                offs = [params.offsets[comp][0], params.offsets[comp][1],
                        -params.offsets[comp][3], -params.offsets[comp][4]]
            for v in offs:
                k = abs(v)
                for _ in range(k):
                    self.e.encode_bin_ep(1)
                if k < max_offset:
                    self.e.encode_bin_ep(0)
            if is_bo:
                for v in offs:
                    if v:
                        self.e.encode_bin_ep(int(v < 0))
                self.e.encode_bins_ep(params.type_aux[comp], 5)
            elif comp != 2:
                self.e.encode_bins_ep(params.type_idc[comp], 2)

    def alf_ctb(self, ctu_rect, ctu_rs_addr: int, pic):
        """Mirror of SyntaxReader._alf_ctb + _ccalf_filter_control_idc:
        per-component ctb flag with left/above context, APS-vs-fixed
        filter index for luma, chroma alternative index, CC-ALF control
        idc (CABACWriter::codeAlfCtuEnableFlag / codeCcAlfFilterControlIdc
        analogue)."""
        sps = self.sps
        sh = self.cs.sh
        if sps.alf and sh.alf_enabled[0]:
            self._alf_ctb_body(ctu_rect, ctu_rs_addr, pic)
        if getattr(sps, "ccalf", False):
            for comp in (1, 2):
                enabled = (sh.ccalf_cb_enabled if comp == 1
                           else sh.ccalf_cr_enabled)
                if enabled:
                    self._ccalf_filter_control_idc(
                        comp, ctu_rs_addr, ctu_rect, pic)

    def _ccalf_filter_control_idc(self, comp: int, ctu_rs_addr: int, ctu,
                                  pic):
        filter_controls = pic.ccalf_control[comp - 1]
        ctu_sz = self.sps.ctu_size
        left = self.cs.get_cu_restricted(
            ctu.x - ctu_sz, ctu.y, ctu.x, ctu.y, CH_L)
        above = self.cs.get_cu_restricted(
            ctu.x, ctu.y - ctu_sz, ctu.x, ctu.y, CH_L)
        c = 0
        if left:
            c += 1 if filter_controls[ctu_rs_addr - 1] else 0
        if above:
            c += 1 if filter_controls[ctu_rs_addr - self.cs.pic_w_ctu] else 0
        c += 3 if comp == 2 else 0
        aps_id = (self.cs.sh.ccalf_cb_aps_id if comp == 1
                  else self.cs.sh.ccalf_cr_aps_id)
        filter_count = self.cs.aps_map[(0, aps_id)].alf.ccalf_filter_count[
            comp - 1]
        idc = int(filter_controls[ctu_rs_addr])
        self.e.encode_bin(1 if idc else 0, ctx("CcAlfFilterControlFlag", c))
        if idc:
            for _ in range(idc - 1):
                self.e.encode_bin_ep(1)
            if idc != filter_count:
                self.e.encode_bin_ep(0)

    def _alf_ctb_body(self, ctu_rect, ctu_rs_addr: int, pic):
        sps = self.sps
        sh = self.cs.sh
        w_ctu = self.cs.pic_w_ctu
        ctu = sps.ctu_size
        left = self.cs.get_cu_restricted(
            ctu_rect.x - ctu, ctu_rect.y, ctu_rect.x, ctu_rect.y, CH_L)
        above = self.cs.get_cu_restricted(
            ctu_rect.x, ctu_rect.y - ctu, ctu_rect.x, ctu_rect.y, CH_L)
        left_addr = ctu_rs_addr - 1 if left else -1
        above_addr = ctu_rs_addr - w_ctu if above else -1
        for comp in range(3):
            if not sh.alf_enabled[comp]:
                continue
            flags = pic.alf_ctb_flag[comp]
            c = 0
            c += 1 if (left_addr > -1 and flags[left_addr]) else 0
            c += 1 if (above_addr > -1 and flags[above_addr]) else 0
            on = int(flags[ctu_rs_addr])
            self.e.encode_bin(on, ctx("ctbAlfFlag", comp * 3 + c))
            if comp == 0 and on:
                self._alf_ctb_filter_index(int(pic.alf_ctb_filter_index[ctu_rs_addr]))
            if comp > 0 and on:
                aps = self.cs.aps_map[(0, sh.alf_aps_id_chroma)]
                num_alts = aps.alf.num_alternatives_chroma
                alt = int(pic.alf_ctb_alt[comp][ctu_rs_addr])
                for i in range(alt):
                    self.e.encode_bin(1, ctx("ctbAlfAlternative", comp - 1))
                if alt < num_alts - 1:
                    self.e.encode_bin(0, ctx("ctbAlfAlternative", comp - 1))

    NUM_ALF_FIXED = 16

    def _alf_ctb_filter_index(self, filt_index: int):
        sh = self.cs.sh
        num_aps = sh.num_alf_aps
        num_avail = num_aps + self.NUM_ALF_FIXED
        if num_avail > self.NUM_ALF_FIXED:
            use_prev = int(filt_index >= self.NUM_ALF_FIXED)
            self.e.encode_bin(use_prev, ctx("AlfUseTemporalFilt"))
            if use_prev:
                if num_aps > 1:
                    self._write_trunc_bin(filt_index - self.NUM_ALF_FIXED,
                                          num_avail - self.NUM_ALF_FIXED)
            else:
                self._write_trunc_bin(filt_index, self.NUM_ALF_FIXED)
        else:
            self._write_trunc_bin(filt_index, self.NUM_ALF_FIXED)

    def _write_trunc_bin(self, symbol: int, max_symbol: int):
        """Inverse of SyntaxReader._trunc_bin."""
        thresh = max_symbol.bit_length() - 1
        val = 1 << thresh
        b = max_symbol - val
        if symbol < val - b:
            self.e.encode_bins_ep(symbol, thresh)
        else:
            t = symbol + (val - b)
            self.e.encode_bins_ep(t >> 1, thresh)
            self.e.encode_bin_ep(t & 1)

    def coding_tree(self, part: P.Partitioner, cu_ctx: CuCtx):
        b = part.cur_block()
        cu = self.cs.get_cu(b.x, b.y, part.ch_type)
        a = part.cur_area()
        is_leaf = (
            cu is not None
            and cu.blocks[0] is not None
            and cu.blocks[0].x == a.x and cu.blocks[0].y == a.y
            and cu.blocks[0].w == a.w and cu.blocks[0].h == a.h
        )
        split_mode = P.CU_DONT_SPLIT if is_leaf else P.CU_QUAD_SPLIT
        self.split_cu_mode(split_mode, part)
        if split_mode != P.CU_DONT_SPLIT:
            part.split_cur_area(split_mode)
            while True:
                if self.helper._area_in_pic(part):
                    self.coding_tree(part, cu_ctx)
                if not part.next_part():
                    break
            part.exit_cur_split()
            return
        self.coding_unit(cu, part, cu_ctx)

    def split_cu_mode(self, split_mode: int, part: P.Partitioner):
        """Mirror of reader split_cu_mode for the chosen mode."""
        can_no, can_qt, can_bh, can_bv, can_th, can_tv = part.can_split_flags()
        ctx_spl, ctx_qt, ctx_hv, ctx_h12, ctx_v12 = self.helper._ctx_split(
            part, (can_no, can_qt, can_bh, can_bv, can_th, can_tv)
        )
        can_split_any = can_bh or can_bv or can_th or can_tv or can_qt
        is_split = split_mode != P.CU_DONT_SPLIT
        if can_no and can_split_any:
            self.e.encode_bin(int(is_split), ctx("SplitFlag", ctx_spl))
        if not is_split:
            return
        can_btt = can_bh or can_bv or can_th or can_tv
        is_qt = split_mode == P.CU_QUAD_SPLIT
        if can_qt and can_btt:
            self.e.encode_bin(int(is_qt), ctx("SplitQtFlag", ctx_qt))
        if is_qt:
            return
        can_hor = can_bh or can_th
        can_ver = can_bv or can_tv
        is_ver = split_mode in (P.CU_VERT_SPLIT, P.CU_TRIV_SPLIT)
        if can_ver and can_hor:
            self.e.encode_bin(int(is_ver), ctx("SplitHvFlag", ctx_hv))
        can14 = can_tv if is_ver else can_th
        can12 = can_bv if is_ver else can_bh
        is12 = split_mode in (P.CU_VERT_SPLIT, P.CU_HORZ_SPLIT)
        if can12 and can14:
            self.e.encode_bin(int(is12), ctx("Split12Flag", ctx_v12 if is_ver else ctx_h12))

    # ------------------------------------------------------------------
    def coding_unit(self, cu: CU, part: P.Partitioner, cu_ctx: CuCtx):
        sh = self.cs.sh
        from vtm_tpu_torch.common.types import SliceType

        if cu_ctx.qg_start:
            cu_ctx.qg_start = False
            cu_ctx.qp = self.helper._predict_qp(cu, cu_ctx.qp)

        is_inter_slice = sh.slice_type != SliceType.I
        if is_inter_slice and cu.blocks[0] is not None:
            # cu_skip_flag (CABACWriter mirror of reader; no IBC)
            if not (cu.lwidth == 4 and cu.lheight == 4):
                c = self.helper._ctx_skip_flag(cu)
                self.e.encode_bin(int(cu.skip), ctx("SkipFlag", c))
        if cu.skip:
            self.prediction_unit(cu)
            return
        if is_inter_slice and not (cu.lwidth == 4 and cu.lheight == 4):
            c = self.helper._ctx_pred_mode(cu)
            self.e.encode_bin(int(cu.pred_mode == MODE_INTRA), ctx("PredMode", c))
        if cu.pred_mode != MODE_INTRA:
            self.prediction_unit(cu)
            self.imv_mode(cu)
            self.cu_bcw_flag(cu)
            if not cu.merge_flag:
                self.e.encode_bin(int(cu.root_cbf), ctx("QtRootCbf"))
            if cu.root_cbf:
                self.sbt_mode(cu)
                for tu in cu.tus:
                    self.transform_unit(tu, cu_ctx, part)
                self.mts_idx(cu)
            return
        self.intra_luma_pred_mode(cu)
        self.intra_chroma_pred_mode(cu)
        if getattr(cu, "isp_mode", 0):
            n = len(cu.tus)
            for i, tu in enumerate(cu.tus):
                self._write_isp_transform_unit(tu, i, n, cu_ctx)
        else:
            for tu in cu.tus:
                self.transform_unit(tu, cu_ctx, part)
        self.residual_lfnst_mode(cu)
        self.mts_idx(cu)

    def _write_isp_transform_unit(self, tu: TU, sub_idx: int, n_tus: int,
                                  cu_ctx: CuCtx | None = None):
        """Mirror of SyntaxReader._isp_transform_unit: chroma cbfs on the
        last sub-TU, luma cbf with the all-previous-zero inference."""
        cu = tu.cu
        has_chroma = (tu.blocks[1] is not None
                      and self.sps.chroma_format_idc != 0)
        if has_chroma:
            self.e.encode_bin(tu.cbf[1], self._cbf_ctx(1, False, False, cu))
            self.e.encode_bin(tu.cbf[2],
                              self._cbf_ctx(2, bool(tu.cbf[1]), False, cu))
        last_cbf_inferred = False
        if sub_idx == n_tus - 1:
            if not any(t.cbf[0] for t in cu.tus[:sub_idx]):
                last_cbf_inferred = True
        if not last_cbf_inferred:
            prev_cbf = bool(cu.tus[sub_idx - 1].cbf[0]) if sub_idx > 0 else False
            self.e.encode_bin(tu.cbf[0], self._cbf_ctx(0, prev_cbf, True, cu))
        else:
            assert tu.cbf[0], "ISP last sub-TU cbf inferred 1 but no residual"
        cbf_chroma = bool(has_chroma and (tu.cbf[1] or tu.cbf[2]))
        if (cu.lwidth > 64 or cu.lheight > 64 or tu.cbf[0] or cbf_chroma) \
                and cu_ctx is not None \
                and self.cs.pps.cu_qp_delta_enabled \
                and not cu_ctx.is_dqp_coded:
            self.cu_qp_delta(cu.qp - cu_ctx.qp)
            cu_ctx.qp = cu.qp
            cu_ctx.is_dqp_coded = True
        if tu.cbf[0]:
            self.residual_coding(tu, 0)
        if has_chroma:
            for comp in (1, 2):
                if tu.cbf[comp]:
                    self.residual_coding(tu, comp)

    def residual_lfnst_mode(self, cu: CU):
        """Mirror of SyntaxReader.residual_lfnst_mode (CABACWriter
        ::residual_lfnst_mode analogue) with the parse-gating flags
        (violates_lfnst, lfnst_last_scan_pos, ts presence) recomputed from
        the coefficients being written."""
        from vtm_tpu_torch.decoder.cabac_reader import LFNST_LAST_SIG_LUMA
        from vtm_tpu_torch.decoder.cs import MTS_SKIP

        sps = self.sps
        ch_idx = 1 if (cu.is_sep_tree and cu.ch_type == CH_C) else 0
        if getattr(cu, "isp_mode", 0) and not self.helper._can_lfnst_with_isp(cu):
            return
        if (
            sps.lfnst
            and cu.pred_mode == MODE_INTRA
            and getattr(cu, "mip_flag", False)
            and not (cu.lwidth >= 16 and cu.lheight >= 16)
        ):
            return
        if cu.is_sep_tree and cu.ch_type == CH_C and min(
            cu.blocks[1].w, cu.blocks[1].h
        ) < 4:
            return
        ref = cu.blocks[ch_idx]
        ref_lw = ref.w << (self.cs.chroma_format.scale_x if ch_idx else 0)
        ref_lh = ref.h << (self.cs.chroma_format.scale_y if ch_idx else 0)
        max_tb = 1 << sps.log2_max_tb_size
        if ref_lw > max_tb or ref_lh > max_tb:
            return
        if not (sps.lfnst and cu.pred_mode == MODE_INTRA):
            return
        violates = [False, False]
        last_ok = False
        is_ts = False
        for tu in cu.tus:
            for comp in range(3):
                b = tu.blocks[comp] if comp < len(tu.blocks) else None
                if b is None or not tu.cbf[comp]:
                    continue
                if tu.mts_idx[comp] == MTS_SKIP:
                    is_ts = True
                    continue
                if b.h >= 4 and b.w >= 4:
                    last = self._last_scan_pos(tu, comp)
                    maxp = 7 if ((b.h == 4 and b.w == 4) or
                                 (b.h == 8 and b.w == 8)) else 15
                    violates[0 if comp == 0 else 1] |= last > maxp
                    last_ok |= last >= LFNST_LAST_SIG_LUMA
        luma_flag = (cu.ch_type == CH_L) if cu.is_sep_tree else True
        chroma_flag = (cu.ch_type == CH_C) if cu.is_sep_tree else True
        non_zero_corner = (luma_flag and violates[0]) or (
            chroma_flag and violates[1])
        if ((not last_ok and not getattr(cu, "isp_mode", 0))
                or non_zero_corner or is_ts):
            assert getattr(cu, "lfnst_idx", 0) == 0, \
                "encoder chose unsignalable lfnst_idx"
            return
        c = 1 if cu.is_sep_tree else 0
        idx = getattr(cu, "lfnst_idx", 0)
        self.e.encode_bin(int(idx != 0), ctx("LFNSTIdx", c))
        if idx:
            self.e.encode_bin(int(idx == 2), ctx("LFNSTIdx", 2))

    def _last_scan_pos(self, tu: TU, comp: int) -> int:
        cctx = CoeffCtx(tu, comp, False, self.sps)
        coeff = tu.coeffs[comp].ravel()
        for sp in range(cctx.max_num_coeff - 1, -1, -1):
            if coeff[cctx.blockpos(sp)]:
                return sp
        return -1

    def mts_idx(self, cu: CU):
        """Mirror of CABACReader::mts_idx with the parse-gating flags
        recomputed from the coefficients being written (violates_mts:
        significant group outside 16x16; mts_last_scan_pos: last > 0)."""
        import numpy as np

        from vtm_tpu_torch.decoder.cs import MTS_SKIP

        if not self.helper._is_mts_allowed(cu):
            return
        if getattr(cu, "lfnst_idx", 0) != 0:
            return
        tu = cu.tus[0]
        mts = tu.mts_idx[0]
        if mts == MTS_SKIP:
            return
        lev = tu.coeffs[0]
        if lev is None:
            return
        nzy, nzx = np.nonzero(lev)
        if nzy.size == 0 or (nzy.size == 1 and nzy[0] == 0 and nzx[0] == 0):
            return  # mts_last_scan_pos false → idx inferred 0
        if (nzx >= 16).any() or (nzy >= 16).any():
            return  # violates_mts → idx inferred 0
        symbol = int(mts != 0)
        self.e.encode_bin(symbol, ctx("MTSIdx", 0))
        if symbol:
            rem = mts - 2  # MTS_DST7_DST7 base
            for i in range(1, 4):
                bit = int(rem >= i)
                self.e.encode_bin(bit, ctx("MTSIdx", i))
                if not bit:
                    break

    # -- inter prediction data (tools-off SPS: regular merge + AMVP only) --

    def prediction_unit(self, cu: CU):
        from vtm_tpu_torch.common.types import SliceType
        from vtm_tpu_torch.decoder import motion as M

        sh = self.cs.sh
        if not cu.skip:
            self.e.encode_bin(int(cu.merge_flag), ctx("MergeFlag"))
        if cu.merge_flag:
            # merge_data mirror (SyntaxReader.merge_data)
            sps = self.sps
            affine = bool(getattr(cu, "affine", False))
            if (sh.slice_type != SliceType.I
                    and self.cs.ph.max_num_affine_merge_cand > 0
                    and cu.lwidth >= 8 and cu.lheight >= 8):
                self.e.encode_bin(int(affine),
                                  ctx("SubblockMergeFlag",
                                      self._ctx_affine_flag(cu)))
            if affine:
                self.merge_idx(cu)
                return
            mmvd = bool(getattr(cu, "mmvd_flag", False)
                        or getattr(cu, "mmvd_skip", False))
            ciip_avail = (sps.ciip and not cu.skip and cu.lwidth < 128
                          and cu.lheight < 128
                          and cu.lwidth * cu.lheight >= 64)
            geo_avail = (getattr(sps, "geo", False) and sh.is_b
                         and sps.max_num_geo_cand > 1
                         and 8 <= cu.lwidth <= 64 and 8 <= cu.lheight <= 64
                         and cu.lwidth < 8 * cu.lheight
                         and cu.lheight < 8 * cu.lwidth)
            regular = bool(getattr(cu, "regular_merge_flag", True))
            if geo_avail or ciip_avail:
                self.e.encode_bin(int(regular),
                                  ctx("RegularMergeFlag", 0 if cu.skip else 1))
            if regular:
                if sps.mmvd:
                    self.e.encode_bin(int(mmvd), ctx("MmvdFlag", 0))
            else:
                if geo_avail and ciip_avail:
                    self.e.encode_bin(int(cu.ciip_flag), ctx("CiipFlag"))
            if mmvd:
                self.mmvd_merge_idx(cu)
            else:
                self.merge_idx(cu)
            return
        if sh.slice_type == SliceType.B:
            self.inter_pred_idc(cu)
        affine = bool(getattr(cu, "affine", False))
        if (sh.slice_type != SliceType.I and self.sps.affine
                and cu.lwidth > 8 and cu.lheight > 8):
            # inter_affine_flag + affine_type (CABACReader affine_flag:2143)
            self.e.encode_bin(int(affine),
                              ctx("AffineFlag", self._ctx_affine_flag(cu)))
            if affine and self.sps.affine_type:
                self.e.encode_bin(int(cu.affine_type), ctx("AffineType"))
        if cu.interdir != 2:
            self.ref_idx(cu, 0)
            if affine:
                self.mvd_coding(cu.mvd_affi[0][0])
                self.mvd_coding(cu.mvd_affi[0][1])
                if cu.affine_type == 1:
                    self.mvd_coding(cu.mvd_affi[0][2])
            else:
                self.mvd_coding(cu.mvd[0])
            self.e.encode_bin(cu.mvp_idx[0], ctx("MVPIdx"))
        if cu.interdir != 1:
            self.ref_idx(cu, 1)
            if not (self.cs.ph.mvd_l1_zero and cu.interdir == 3):
                if affine:
                    self.mvd_coding(cu.mvd_affi[1][0])
                    self.mvd_coding(cu.mvd_affi[1][1])
                    if cu.affine_type == 1:
                        self.mvd_coding(cu.mvd_affi[1][2])
                else:
                    self.mvd_coding(cu.mvd[1])
            self.e.encode_bin(cu.mvp_idx[1], ctx("MVPIdx"))

    def ref_idx(self, cu: CU, lst: int):
        """Mirror of SyntaxReader.ref_idx (CABACReader ref_idx:2433)."""
        if getattr(cu, "smvd_mode", 0):
            return
        num_ref = self.cs.sh.num_ref_idx[lst]
        if num_ref <= 1:
            return
        idx = cu.ref_idx[lst]
        self.e.encode_bin(int(idx > 0), ctx("RefPic"))
        if idx == 0 or num_ref <= 2:
            return
        self.e.encode_bin(int(idx > 1), ctx("RefPic", 1))
        if idx == 1:
            return
        for k in range(2, idx):
            self.e.encode_bin_ep(1)
        if idx < num_ref - 1:
            self.e.encode_bin_ep(0)

    def inter_pred_idc(self, cu: CU):
        """Mirror of CABACReader::inter_pred_idc (CABACReader.cpp:2402)."""
        from vtm_tpu_torch.decoder import motion as M

        if not M.is_bipred_restriction(cu):
            w, h = cu.lwidth, cu.lheight
            c = 7 - (((w.bit_length() - 1) + (h.bit_length() - 1) + 1) >> 1)
            self.e.encode_bin(int(cu.interdir == 3), ctx("InterDir", c))
            if cu.interdir == 3:
                return
        self.e.encode_bin(int(cu.interdir == 2), ctx("InterDir", 5))

    def _w_sbt_allowed(self, cu: CU) -> int:
        """Mirror of SyntaxReader._sbt_allowed (CU::checkAllowedSbt)."""
        if (not self.sps.sbt or cu.pred_mode != D.MODE_INTER
                or getattr(cu, "ciip_flag", False)):
            return 0
        w, h = cu.lwidth, cu.lheight
        max_size = 1 << self.sps.log2_max_tb_size
        if w > max_size or h > max_size:
            return 0
        min_size = 8
        mask = 0
        mask |= (w >= min_size) << 1
        mask |= (h >= min_size) << 2
        mask |= (w >= min_size * 2) << 3
        mask |= (h >= min_size * 2) << 4
        return mask

    def sbt_mode(self, cu: CU):
        """Mirror of SyntaxReader.sbt_mode (SyntaxReader.sbt_mode twin; CABACReader.cpp sbt_mode:1547)."""
        allowed = self._w_sbt_allowed(cu)
        if not allowed:
            return
        w, h = cu.lwidth, cu.lheight
        info = getattr(cu, "sbt_info", 0)
        c = 1 if w * h <= 256 else 0
        self.e.encode_bin(int(bool(info)), ctx("SbtFlag", c))
        if not info:
            return
        sbt_idx = info & 0xF
        pos = (info >> 4) & 3
        ver_half = (allowed >> 1) & 1
        hor_half = (allowed >> 2) & 1
        ver_quad = (allowed >> 3) & 1
        hor_quad = (allowed >> 4) & 1
        quad = 1 if sbt_idx in (3, 4) else 0
        if (hor_half or ver_half) and (hor_quad or ver_quad):
            self.e.encode_bin(quad, ctx("SbtQuadFlag"))
        hor = 1 if sbt_idx in (2, 4) else 0
        if (quad and ver_quad and hor_quad) or (not quad and ver_half and hor_half):
            c = 0 if w == h else (1 if w < h else 2)
            self.e.encode_bin(hor, ctx("SbtHorFlag", c))
        self.e.encode_bin(pos, ctx("SbtPosFlag"))

    def imv_mode(self, cu: CU):
        """Mirror of SyntaxReader.imv_mode (CABACReader imv_mode:962)."""
        from vtm_tpu_torch.decoder import motion as M

        sps = self.sps
        if not sps.amvr:
            return
        if not self._w_has_nonzero_mvd(cu):
            return
        if getattr(cu, "affine", False):
            return
        imv = getattr(cu, "imv", 0)
        self.e.encode_bin(int(imv > 0), ctx("ImvFlag", 0))
        if imv:
            v = int(imv != M.IMV_HPEL)
            self.e.encode_bin(v, ctx("ImvFlag", 4))
            if v:
                self.e.encode_bin(int(imv == 2), ctx("ImvFlag", 1))

    def cu_bcw_flag(self, cu: CU):
        """Mirror of SyntaxReader.cu_bcw_flag (CABACReader cu_bcw_flag:1211)."""
        if not self._w_is_bcw_coded(cu):
            return
        order = [2, 3, 1, 4, 0]  # g_BcwParsingOrder
        idx = order.index(getattr(cu, "bcw_idx", 2))
        self.e.encode_bin(int(idx > 0), ctx("BcwIdx"))
        if idx:
            num_bcw = 5 if self.cs.sh.check_ldc else 3
            for _ in range(idx - 1):
                self.e.encode_bin_ep(1)
            if idx < num_bcw - 1:
                self.e.encode_bin_ep(0)

    def _w_is_bcw_coded(self, cu: CU) -> bool:
        if not self.sps.bcw or cu.pred_mode == MODE_INTRA:
            return False
        if cu.merge_flag or cu.interdir != 3:
            return False
        if cu.lwidth * cu.lheight < 256:
            return False
        if self.cs.sh.wp_present(cu.ref_idx):
            return False
        return True

    def _w_has_nonzero_mvd(self, cu: CU) -> bool:
        """CU::hasSubCUNonZeroMVd mirror."""
        if cu.merge_flag or cu.pred_mode == MODE_INTRA:
            return False
        nz = False
        if cu.interdir != 2:
            nz |= cu.mvd[0] != (0, 0)
        if cu.interdir != 1:
            if not (self.cs.ph.mvd_l1_zero and cu.interdir == 3):
                nz |= cu.mvd[1] != (0, 0)
        return nz

    def mmvd_merge_idx(self, cu: CU):
        """Mirror of SyntaxReader.mmvd_merge_idx (base, step, direction)."""
        var0 = cu.mmvd_idx // 32
        var1 = (cu.mmvd_idx % 32) // 4
        var2 = cu.mmvd_idx % 4
        if self.sps.max_num_merge_cand > 1:
            self.e.encode_bin(var0, ctx("MmvdMergeIdx"))
        self.e.encode_bin(int(var1 > 0), ctx("MmvdStepMvpIdx"))
        if var1 > 0:
            for _ in range(var1 - 1):
                self.e.encode_bin_ep(1)
            if var1 < 7:
                self.e.encode_bin_ep(0)
        self.e.encode_bin_ep(var2 >> 1)
        self.e.encode_bin_ep(var2 & 1)

    def _ctx_affine_flag(self, cu: CU) -> int:
        """Mirror of SyntaxReader._ctx_affine_flag (neighbor affine CUs)."""
        from vtm_tpu_torch.decoder.cs import CH_L

        x, y = cu.lx, cu.ly
        left = self.cs.get_cu_restricted(x - 1, y, x, y, CH_L)
        above = self.cs.get_cu_restricted(x, y - 1, x, y, CH_L)
        return (1 if (left and getattr(left, "affine", False)) else 0) + (
            1 if (above and getattr(above, "affine", False)) else 0)

    def merge_idx(self, cu: CU):
        if getattr(cu, "affine", False):
            # affine/subblock merge index (reader merge_idx affine branch)
            n_minus1 = self.cs.ph.max_num_affine_merge_cand - 1
            idx = cu.merge_idx
            if n_minus1 > 0:
                self.e.encode_bin(int(idx > 0), ctx("AffMergeIdx"))
                for k in range(1, idx + 1):
                    if k < n_minus1:
                        self.e.encode_bin_ep(int(idx > k))
            return
        if getattr(cu, "geo_flag", False):
            # GEO: split dir (truncated binary 64) + two merge indices
            # (mirror of SyntaxReader.merge_idx geo branch)
            self._write_trunc_bin(cu.geo_split_dir, 64)
            max_geo = self.sps.max_num_geo_cand
            n_minus2 = max_geo - 2
            m0, m1 = cu.geo_merge_idx
            m1c = m1 - (1 if m1 > m0 else 0)
            self.e.encode_bin(int(m0 > 0), ctx("MergeIdx"))
            if m0 > 0:
                self._write_unary_max_eqprob(m0 - 1, n_minus2)
            if n_minus2 > 0:
                self.e.encode_bin(int(m1c > 0), ctx("MergeIdx"))
                if m1c > 0:
                    self._write_unary_max_eqprob(m1c - 1, n_minus2 - 1)
            return
        n_minus1 = self.sps.max_num_merge_cand - 1
        idx = cu.merge_idx
        if n_minus1 > 0:
            self.e.encode_bin(int(idx > 0), ctx("MergeIdx"))
            if idx > 0:
                for k in range(1, min(idx, n_minus1 - 1) + 1):
                    if k < n_minus1:
                        self.e.encode_bin_ep(int(idx > k))

    def _write_unary_max_eqprob(self, value: int, max_symbol: int):
        """Mirror of SyntaxReader._unary_max_eqprob."""
        if max_symbol == 0:
            return
        for k in range(value):
            self.e.encode_bin_ep(1)
        if value < max_symbol:
            self.e.encode_bin_ep(0)

    def mvd_coding(self, mvd):
        hor, ver = mvd
        h_abs, v_abs = abs(hor), abs(ver)
        self.e.encode_bin(int(h_abs > 0), ctx("Mvd"))
        self.e.encode_bin(int(v_abs > 0), ctx("Mvd"))
        if h_abs:
            self.e.encode_bin(int(h_abs > 1), ctx("Mvd", 1))
        if v_abs:
            self.e.encode_bin(int(v_abs > 1), ctx("Mvd", 1))
        if h_abs:
            if h_abs > 1:
                self.e.encode_rem_abs_ep(h_abs - 2, 1, 0, 17)
            self.e.encode_bin_ep(int(hor < 0))
        if v_abs:
            if v_abs > 1:
                self.e.encode_rem_abs_ep(v_abs - 2, 1, 0, 17)
            self.e.encode_bin_ep(int(ver < 0))

    def intra_luma_pred_mode(self, cu: CU):
        """Mirror of SyntaxReader.intra_luma_pred_modes (CABACWriter
        ::intra_luma_pred_modes analogue): mip_flag + mip modes, MRL index,
        then MPM/non-MPM signalling with the MRL inference."""
        if cu.blocks[0] is None:
            return
        if getattr(cu, "bdpcm_mode", 0):
            return
        mode = cu.intra_dir[0]
        if self.sps.mip:
            x, y = cu.lx, cu.ly
            left_cu = self.cs.get_cu_restricted(x - 1, y, x, y, CH_L)
            above_cu = self.cs.get_cu_restricted(x, y - 1, x, y, CH_L)
            c = (1 if (left_cu and getattr(left_cu, "mip_flag", False)) else 0) \
                + (1 if (above_cu and getattr(above_cu, "mip_flag", False)) else 0)
            if cu.lwidth > 2 * cu.lheight or cu.lheight > 2 * cu.lwidth:
                c = 3
            mip = bool(getattr(cu, "mip_flag", False))
            self.e.encode_bin(int(mip), ctx("MipFlag", c))
            if mip:
                self.e.encode_bin_ep(int(cu.mip_transposed))
                num_modes = SyntaxReader._num_mip_modes(cu.lwidth, cu.lheight)
                self._write_trunc_bin(mode, num_modes)
                return
        mrl = getattr(cu, "multi_ref_idx", 0)
        if (self.sps.mrl
                and (cu.blocks[0].y & (self.sps.ctu_size - 1)) != 0):
            self.e.encode_bin(int(mrl > 0), ctx("MultiRefLineIdx", 0))
            if mrl > 0:
                self.e.encode_bin(int(mrl > 1), ctx("MultiRefLineIdx", 1))
        if (self.sps.isp and mrl == 0
                and not getattr(cu, "bdpcm_mode", 0)
                and self.helper._can_use_isp(cu)
                and not getattr(cu, "color_transform", False)):
            isp = getattr(cu, "isp_mode", 0)
            self.e.encode_bin(int(isp != 0), ctx("ISPMode", 0))
            if isp:
                self.e.encode_bin(isp - 1, ctx("ISPMode", 1))
        mpm = self.helper._get_intra_mpms(cu)
        if mrl:
            idx = mpm.index(mode)
            assert idx >= 1, "MRL excludes planar (mpm[0])"
            self.e.encode_bin_ep(int(idx > 1))
            if idx > 1:
                self.e.encode_bin_ep(int(idx > 2))
            if idx > 2:
                self.e.encode_bin_ep(int(idx > 3))
            if idx > 3:
                self.e.encode_bin_ep(int(idx > 4))
            return
        if mode in mpm:
            idx = mpm.index(mode)
            self.e.encode_bin(1, ctx("IntraLumaMpmFlag"))
            c = 0 if cu.isp_mode else 1
            self.e.encode_bin(int(idx > 0), ctx("IntraLumaPlanarFlag", c))
            if idx > 0:
                self.e.encode_bin_ep(int(idx > 1))
            if idx > 1:
                self.e.encode_bin_ep(int(idx > 2))
            if idx > 2:
                self.e.encode_bin_ep(int(idx > 3))
            if idx > 3:
                self.e.encode_bin_ep(int(idx > 4))
        else:
            self.e.encode_bin(0, ctx("IntraLumaMpmFlag"))
            srt = sorted(mpm)
            code = mode
            for m in reversed(srt):
                if code > m:
                    code -= 1
            self._write_trunc_bin(code, D.NUM_LUMA_MODE - NUM_MPM)

    def _write_trunc_bin(self, symbol: int, max_symbol: int):
        thresh = max_symbol.bit_length() - 1
        val = 1 << thresh
        b = max_symbol - val
        if symbol < val - b:
            self.e.encode_bins_ep(symbol, thresh)
        else:
            s2 = symbol + (val - b)
            self.e.encode_bins_ep(s2 >> 1, thresh)
            self.e.encode_bin_ep(s2 & 1)

    def intra_chroma_pred_mode(self, cu: CU):
        if self.sps.chroma_format_idc == 0 or (cu.is_sep_tree and cu.ch_type == CH_L):
            return
        if cu.blocks[1] is None:
            return
        mode = cu.intra_dir[1]
        if self.sps.cclm and self.helper._cclm_allowed(cu):
            is_lm = mode in (D.LM_CHROMA_IDX, D.MDLM_L_IDX, D.MDLM_T_IDX)
            self.e.encode_bin(int(is_lm), ctx("CclmModeFlag"))
            if is_lm:
                symbol = [D.LM_CHROMA_IDX, D.MDLM_L_IDX,
                          D.MDLM_T_IDX].index(mode)
                self.e.encode_bin(int(symbol > 0), ctx("CclmModeIdx"))
                if symbol > 0:
                    self.e.encode_bin_ep(symbol - 1)
                return
        if mode == D.DM_CHROMA_IDX:
            self.e.encode_bin(0, ctx("IntraChromaPredMode"))
            return
        self.e.encode_bin(1, ctx("IntraChromaPredMode"))
        modes = self.helper._chroma_cand_modes(cu)
        cand = modes.index(mode)
        self.e.encode_bins_ep(cand, 2)

    # ------------------------------------------------------------------
    def transform_unit(self, tu: TU, cu_ctx: CuCtx, part: P.Partitioner):
        cu = tu.cu
        has_chroma = self.sps.chroma_format_idc != 0 and tu.blocks[1] is not None
        sbt_info = getattr(cu, "sbt_info", 0)
        sbt_no_res = bool(sbt_info) and getattr(tu, "no_residual", False)
        if has_chroma and (not cu.is_sep_tree or part.ch_type == CH_C):
            if not sbt_no_res:
                self.e.encode_bin(tu.cbf[1], self._cbf_ctx(1, False, False, cu))
                self.e.encode_bin(tu.cbf[2], self._cbf_ctx(2, bool(tu.cbf[1]), False, cu))
        if part.ch_type == CH_L and tu.blocks[0] is not None:
            sig_chroma = bool(tu.cbf[1] or tu.cbf[2]) if has_chroma else False
            if cu.pred_mode != MODE_INTRA and tu.depth == 0 and not sig_chroma:
                assert tu.cbf[0], "inter root TU luma cbf inferred 1"
            elif sbt_no_res:
                assert not tu.cbf[0], "SBT no-residual TU luma cbf inferred 0"
            elif sbt_info and not sig_chroma:
                assert tu.cbf[0], "SBT residual TU luma cbf inferred 1"
            else:
                self.e.encode_bin(tu.cbf[0], self._cbf_ctx(0, False, False, cu))
        cbf_chroma = bool(tu.cbf[1] or tu.cbf[2]) if has_chroma else False
        if (cu.lwidth > 64 or cu.lheight > 64 or tu.cbf[0] or cbf_chroma) \
                and (not cu.is_sep_tree or part.ch_type == CH_L):
            if self.cs.pps.cu_qp_delta_enabled and not cu_ctx.is_dqp_coded:
                self.cu_qp_delta(cu.qp - cu_ctx.qp)
                cu_ctx.qp = cu.qp
                cu_ctx.is_dqp_coded = True
        if tu.cbf[0]:
            self.residual_coding(tu, 0)
        if has_chroma:
            for comp in (1, 2):
                if tu.cbf[comp]:
                    self.residual_coding(tu, comp)

    def cu_qp_delta(self, dqp: int):
        """Mirror of SyntaxReader.cu_qp_delta: unary-max(5) prefix with
        DeltaQP contexts, EG0 escape, EP sign."""
        from vtm_tpu_torch.decoder.cabac_reader import CU_DQP_TU_CMAX

        v = abs(dqp)
        pre = min(v, CU_DQP_TU_CMAX)
        for k in range(pre):
            self.e.encode_bin(1, ctx("DeltaQP", 0 if k == 0 else 1))
        if pre < CU_DQP_TU_CMAX:
            self.e.encode_bin(0, ctx("DeltaQP", 0 if pre == 0 else 1))
        else:
            self._write_exp_golomb_eqprob(v - CU_DQP_TU_CMAX, 0)
        if v > 0:
            self.e.encode_bin_ep(int(dqp < 0))

    def _write_exp_golomb_eqprob(self, symbol: int, count: int):
        """Mirror of SyntaxReader._exp_golomb_eqprob."""
        while symbol >= (1 << count):
            self.e.encode_bin_ep(1)
            symbol -= 1 << count
            count += 1
        self.e.encode_bin_ep(0)
        if count:
            self.e.encode_bins_ep(symbol, count)

    def _cbf_ctx(self, comp: int, prev_cbf: bool, use_isp: bool, cu) -> int:
        if use_isp and comp == 0:
            c = 2 + int(prev_cbf)
        elif comp == 2:
            c = 1 if prev_cbf else 0
        else:
            c = 0
        if (comp == 0 and getattr(cu, "bdpcm_mode", 0)) or (
                comp != 0 and getattr(cu, "bdpcm_mode_chroma", 0)):
            c = 1 if comp in (0, 1) else 2
        return ctx(f"QtCbf_{comp}", c)

    def residual_coding(self, tu: TU, comp: int):
        from vtm_tpu_torch.encoder.bin_encoder import BitEstimator

        if isinstance(self.e, BitEstimator):
            mod = _native_est()
            if mod:
                from vtm_tpu_torch.decoder.cabac_reader import _rc_static

                b = tu.blocks[comp]
                ch = 0 if comp == 0 else 1
                st = _rc_static(b.w, b.h, ch)
                ratio = (MAX_CTX_BIN_RATIO_LUMA if comp == 0
                         else MAX_CTX_BIN_RATIO_CHROMA)
                w = min(32, b.w)
                h = min(32, b.h)
                reg_bin_limit = (w * h * ratio) >> 4
                state_trans = 32040 if self.cs.sh.dep_quant else 0
                flat = np.ascontiguousarray(tu.coeffs[comp].ravel(),
                                            dtype=np.int32)
                fb, _last = mod.rc_est(
                    self.e.ctx, flat, st[0], st[1], b.w, b.h, st[2], st[3],
                    ch, state_trans, reg_bin_limit,
                    st[4], st[5], st[6], st[7], st[8], st[9],
                    st[10], st[11], st[12], st[13], st[14], st[15], st[16],
                    st[17], st[18])
                self.e.frac_bits += fb
                return
        cctx = CoeffCtx(tu, comp, False, self.sps)
        coeff = tu.coeffs[comp].ravel()
        # last significant position
        last_scan_pos = -1
        for sp in range(cctx.max_num_coeff - 1, -1, -1):
            if coeff[cctx.blockpos(sp)]:
                last_scan_pos = sp
                break
        assert last_scan_pos >= 0, "residual_coding called with all-zero block"
        cctx.scan_pos_last = last_scan_pos
        self._write_last_pos(cctx, last_scan_pos)
        ratio = MAX_CTX_BIN_RATIO_LUMA if comp == 0 else MAX_CTX_BIN_RATIO_CHROMA
        w = min(32, tu.blocks[comp].w)
        h = min(32, tu.blocks[comp].h)
        cctx.reg_bin_limit = (w * h * ratio) >> 4
        state_trans = 32040 if self.cs.sh.dep_quant else 0
        state = 0
        for subset in range(last_scan_pos >> cctx.log2_cg_size, -1, -1):
            cctx.init_subblock(subset)
            state = self._write_subblock(cctx, coeff, state_trans, state)

    def _write_last_pos(self, cctx: CoeffCtx, last_scan_pos: int):
        pos_x = int(cctx.scan[last_scan_pos][1])
        pos_y = int(cctx.scan[last_scan_pos][2])
        gx = int(_GROUP_IDX[pos_x])
        gy = int(_GROUP_IDX[pos_y])
        max_x = cctx.max_last_pos_x
        max_y = cctx.max_last_pos_y
        for i in range(gx):
            self.e.encode_bin(1, cctx.last_x_ctx_id(i))
        if gx < max_x:
            self.e.encode_bin(0, cctx.last_x_ctx_id(gx))
        for i in range(gy):
            self.e.encode_bin(1, cctx.last_y_ctx_id(i))
        if gy < max_y:
            self.e.encode_bin(0, cctx.last_y_ctx_id(gy))
        if gx > 3:
            n = (gx - 2) >> 1
            self.e.encode_bins_ep(pos_x - int(_MIN_IN_GROUP[gx]), n)
        if gy > 3:
            n = (gy - 2) >> 1
            self.e.encode_bins_ep(pos_y - int(_MIN_IN_GROUP[gy]), n)

    def _write_subblock(self, cctx: CoeffCtx, coeff: np.ndarray,
                        state_trans: int, state: int) -> int:
        e = self.e
        min_sub_pos = cctx.min_sub_pos
        is_last = cctx.is_last()
        first_sig_pos = cctx.scan_pos_last if is_last else cctx.max_sub_pos
        # significant group flag
        sig_group = any(
            coeff[cctx.blockpos(sp)] for sp in range(min_sub_pos, cctx.max_sub_pos + 1)
        )
        if not (is_last or cctx.sub_set_id == 0):
            e.encode_bin(int(sig_group), cctx.sig_group_ctx_id())
            if not sig_group:
                return state
        # the last and DC subblocks have coded_sub_block_flag inferred 1:
        # even an all-zero DC subblock must code its (all-zero) sig flags
        # (the reader reads them — an early return here desyncs the
        # stream; the context-aware DQ trellis legitimately produces
        # all-zero DC subblocks)
        cctx.sig_group_flags[cctx.sub_set_pos] = True
        infer_sig_pos = (
            (min_sub_pos if cctx.sub_set_id != 0 else -1)
            if first_sig_pos != cctx.scan_pos_last
            else first_sig_pos
        )
        num_nonzero = 0
        rem_reg_bins = cctx.reg_bin_limit
        pos = first_sig_pos
        remainders = []  # (scan_pos, remainder)
        ctx_off = {}
        while pos >= min_sub_pos and rem_reg_bins >= 4:
            blk_pos = cctx.blockpos(pos)
            level = abs(int(coeff[blk_pos]))
            sig = int(level != 0)
            inferred = num_nonzero == 0 and pos == infer_sig_pos
            if not inferred:
                sig_ctx = cctx.sig_ctx_id_abs(pos, coeff, state)
                e.encode_bin(sig, sig_ctx)
                rem_reg_bins -= 1
            elif pos != cctx.scan_pos_last:
                cctx.sig_ctx_id_abs(pos, coeff, state)
            if sig:
                off = cctx.ctx_offset_abs()
                ctx_off[pos] = off
                num_nonzero += 1
                gt1 = int(level > 1)
                e.encode_bin(gt1, cctx.gt1_ctx_id(off))
                rem_reg_bins -= 1
                if gt1:
                    par = (level - 2) & 1
                    e.encode_bin(par, cctx.par_ctx_id(off))
                    rem_reg_bins -= 1
                    gt2 = int(level > 3)
                    e.encode_bin(gt2, cctx.gt2_ctx_id(off))
                    rem_reg_bins -= 1
            # dep-quant state machine (parity of the full level equals the
            # parity of the partial level the reader tracks here)
            state = (state_trans >> ((state << 2) + ((level & 1) << 1))) & 3
            pos -= 1
        first_pos_mode2 = pos
        cctx.reg_bin_limit = rem_reg_bins
        # remainder pass (>= 4)
        for sp in range(first_sig_pos, first_pos_mode2, -1):
            blk_pos = cctx.blockpos(sp)
            level = abs(int(coeff[blk_pos]))
            sum_all = cctx.template_abs_sum(sp, coeff, 4)
            rice = int(_GO_RICE_PARS[sum_all])
            if level >= 4:
                rem = (level - 4) >> 1
                e.encode_rem_abs_ep(rem, rice, COEF_REMAIN_BIN_REDUCTION, 15)
        # bypass pass
        for sp in range(first_pos_mode2, min_sub_pos - 1, -1):
            blk_pos = cctx.blockpos(sp)
            level = abs(int(coeff[blk_pos]))
            sum_all = cctx.template_abs_sum(sp, coeff, 0)
            rice = int(_GO_RICE_PARS[sum_all])
            pos0 = (1 if state < 2 else 2) << rice
            if level == 0:
                rem = pos0
            elif level <= pos0:
                rem = level - 1
            else:
                rem = level
            e.encode_rem_abs_ep(rem, rice, COEF_REMAIN_BIN_REDUCTION, 15)
            state = (state_trans >> ((state << 2) + ((level & 1) << 1))) & 3
            if level:
                num_nonzero += 1
        # signs
        sign_bits = []
        for sp in range(first_sig_pos, min_sub_pos - 1, -1):
            v = int(coeff[cctx.blockpos(sp)])
            if v:
                sign_bits.append(1 if v < 0 else 0)
        num_signs = len(sign_bits)
        if num_signs:
            pattern = 0
            for s in sign_bits:
                pattern = (pattern << 1) | s
            e.encode_bins_ep(pattern, num_signs)
        return state
