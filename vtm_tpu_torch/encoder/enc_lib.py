"""All-intra encoder of the port: vtm_tpu's IntraEncoder with its sample
kernels on a torch device.

The RD search, CABAC writer, SAO / ALF / CC-ALF parameter searches,
quantisation and the reconstruction are vtm_tpu's, unchanged (host numpy).
This subclass overrides only the two methods that reach jax, copied line
for line from vtm_tpu/encoder/enc_lib.py except at these call sites:

* `encode_frame` (L185-324): the port's FrameRMD (encoder/rmd.py, the
  batched RMD and SATD kernels) and the port's deblock_picture;
* `_sao_and_rewrite` (L358-452): the port's sao_picture and alf_picture.

Every filter stage uploads the reconstruction, filters it on the device
and writes it back into the numpy planes the RD search reads.
"""

from __future__ import annotations

import numpy as np

from vtm_tpu.bitstream import reader as nalio
from vtm_tpu.bitstream.writer import BitWriter, make_nal
from vtm_tpu.common.types import SliceType
from vtm_tpu.decoder import cs as D
from vtm_tpu.decoder import partitioner as P
from vtm_tpu.decoder import vlc
from vtm_tpu.decoder.cabac import ContextModels
from vtm_tpu.decoder.cabac_reader import CuCtx
from vtm_tpu.decoder.cs import Rect
from vtm_tpu.decoder.dec_cu import CuReconstructor
from vtm_tpu.encoder import enc_lib as REF
from vtm_tpu.encoder import vlc_writer as W
from vtm_tpu.encoder.bin_encoder import BinEncoder, BitEstimator
from vtm_tpu.encoder.cabac_writer import SyntaxWriter
from vtm_tpu.utils import pic_hash
from vtm_tpu_torch.device import resolve_device

# the reference's configuration, taken unchanged (host-only, no jax)
EncoderConfig = REF.EncoderConfig


class IntraEncoder(REF.IntraEncoder):
    """vtm_tpu.encoder.enc_lib.IntraEncoder on `device` ("cuda" or "cpu";
    CUDA without a card raises)."""

    def __init__(self, cfg, device="cuda"):
        self.device = resolve_device(device)
        super().__init__(cfg)

    def encode_frame(self, src_planes, poc: int) -> bytes:
        cfg = self.cfg
        sps, pps = self.sps, self.pps
        # picture-header fixups (normally done at PH parse)
        from vtm_tpu.common.params import PicHeader, SliceHeader

        vlc.derive_pps_partitioning(pps, sps)
        ph = PicHeader()
        ph.inter_slice_allowed = False
        ph.min_qt_size = list(sps.min_qt_size)
        ph.max_mtt_depth = list(sps.max_mtt_depth)
        ph.max_bt_size = list(sps.max_bt_size)
        ph.max_tt_size = list(sps.max_tt_size)
        self.frame_qp = cfg.qp
        self.lam = 0.57 * 2.0 ** ((self.frame_qp - 12) / 3.0)
        self._base_lam = self.lam
        self._aqp_dqp = (self._aqp_map(src_planes[0].astype(np.int64))
                         if cfg.aqp else {})
        self._ctu_rc = None  # CTU rate control applies to inter frames only
        self._qg_carry = self.frame_qp
        sh = SliceHeader()
        sh.slice_type = SliceType.I
        sh.qp = self.frame_qp
        sh.sao_enabled = [cfg.sao, cfg.sao and cfg.chroma_format_idc != 0]
        sh.dep_quant = cfg.dep_quant
        n_ctu = pps.pic_width_in_ctu(sps.ctu_size) * pps.pic_height_in_ctu(sps.ctu_size)
        dcs = D.DecCodingStructure(sps, pps, ph, sh, np.zeros(n_ctu, dtype=np.int32))
        dcs._slice_headers = [sh]
        dcs.lmcs_model = None
        self.dcs = dcs
        from vtm_tpu.decoder.cabac_reader import SyntaxReader

        self._helper = SyntaxReader(dcs, None)
        self.src = src_planes
        self._frame_rmd = None
        if cfg.satd_rmd:
            # port: the batched RMD on self.device (reference L221-223)
            from vtm_tpu_torch.encoder.rmd import FrameRMD

            self._frame_rmd = FrameRMD(src_planes[0], cfg, self.lam ** 0.5,
                                       self.device)
        planes = [np.zeros_like(p) for p in src_planes]
        self.recon = CuReconstructor(dcs, planes)
        # CABAC state
        ctx = ContextModels()
        ctx.init(self.frame_qp, int(SliceType.I))
        slice_bw = BitWriter()
        enc = BinEncoder(slice_bw, ctx)
        enc.start()
        import os
        tr_path = os.environ.get("VTM_TPU_ENC_TRACE")
        if tr_path:
            if not hasattr(self, "_trace_f"):
                self._trace_f = open(tr_path, "w")
            enc.trace = self._trace_f
        w_ctu = dcs.pic_w_ctu
        h_ctu = dcs.pic_h_ctu
        rep_ctx = CuCtx(self.frame_qp)  # slice-persistent QP chain
        # fast-RD phase 1: whole-frame partition DP from the reduced RMD
        # stats, then ONE device gather of the chosen leaves' full mode
        # rows (2 device syncs per frame total)
        fast_maps = {}
        if cfg.fast_rd and self._frame_rmd is not None:
            leaves = []
            for cy in range(h_ctu):
                for cx in range(w_ctu):
                    ctu_rect = Rect(cx * cfg.ctu_size, cy * cfg.ctu_size,
                                    cfg.ctu_size, cfg.ctu_size)
                    part = P.Partitioner(dcs)
                    part.init_ctu(ctu_rect, D.CH_L)
                    r = self._fast_rd_node(part)
                    if r is not None:
                        fast_maps[(ctu_rect.x, ctu_rect.y)] = r[1]
                        leaves.extend(
                            k[:4] for k, v in r[1].items()
                            if v == P.CU_DONT_SPLIT)
            self._frame_rmd.prefetch_rows(
                [(x, y, w, h) for (x, y, w, h) in leaves])
            if len(fast_maps) == w_ctu * h_ctu:
                # every CTU is table-decided: release the full on-device
                # cost tensors now
                self._frame_rmd._full = {}
        for cy in range(h_ctu):
            for cx in range(w_ctu):
                ctu_rect = Rect(cx * cfg.ctu_size, cy * cfg.ctu_size,
                                cfg.ctu_size, cfg.ctu_size)
                # RD search with estimator seeded from live contexts
                est = BitEstimator(ctx.copy())
                self._enter_ctu_qp(ctu_rect)
                fast = fast_maps.get((ctu_rect.x, ctu_rect.y))
                if fast is not None:
                    self._split_map = fast
                    cpart = P.Partitioner(dcs)
                    cpart.init_ctu(ctu_rect, D.CH_L)
                    self._commit_node(cpart, est)
                else:
                    part = P.Partitioner(dcs)
                    part.init_ctu(ctu_rect, D.CH_L)
                    _, self._split_map = self._rd_node(part, est)
                self.__dict__.setdefault("_ctu_split_maps", {})[
                    (ctu_rect.x, ctu_rect.y)] = self._split_map
                # final write: replay chosen tree with the real encoder
                writer = SyntaxWriter(dcs, enc)
                wpart = P.Partitioner(dcs)
                wpart.init_ctu(ctu_rect, D.CH_L)
                self._replay_node(writer, wpart, rep_ctx)
                # VVC: terminating bin only at slice/tile/WPP-row end
                # (DecSlice.cpp:141-234); v1 has one slice, no tiles/WPP.
                if cy == h_ctu - 1 and cx == w_ctu - 1:
                    enc.encode_bin_trm(1)
        enc.finish()
        slice_bw.write_byte_alignment()
        # in-loop filters on reconstruction (DecLib::executeLoopFilters order)
        from vtm_tpu_torch.ops import deblock as DB

        class _PicShim:
            pass

        shim = _PicShim()
        shim.planes = planes
        if not sh.deblocking_disable:
            # port: deblocking on self.device (reference L305)
            DB.deblock_picture(dcs, shim, self.device)
        entry_points = None
        self._alf_aps_nal = b""
        if cfg.sao or cfg.wpp or cfg.alf:
            slice_bw, entry_points = self._sao_and_rewrite(shim, SliceType.I)
        # slice NAL = header + slice data
        hdr = W.write_slice_header_head(cfg, poc, self.frame_qp,
                                        sao=tuple(sh.sao_enabled),
                                        entry_points=entry_points,
                                        alf=sh)
        rbsp = bytes(hdr.bytes) + slice_bw.data()
        nal = make_nal(nalio.NAL_IDR_N_LP, rbsp)
        # hash SEI (computed on the filtered reconstruction, like VTM)
        sei = b""
        if cfg.hash_sei:
            digest = pic_hash.pic_md5(planes, [cfg.bit_depth] * len(planes))
            sei = W.write_hash_sei(digest)
        self.last_recon = planes
        self._log_picture(poc, "I", self.frame_qp, len(nal) * 8, planes)
        return self._alf_aps_nal + nal + sei

    def _sao_and_rewrite(self, shim, slice_type):
        """Filter-parameter search + final entropy pass (the reference's
        two-pass compressSlice -> filters -> encodeSlice flow,
        EncGOP.cpp:2874-3324). With cfg.wpp, writes one CABAC substream per
        CTU row with the 1-CTU-delayed context sync (EncSlice.cpp:1833-1868)
        and returns (BitWriter, entry_point_sizes)."""
        from vtm_tpu.decoder.cabac_reader import SaoParams
        from vtm_tpu.encoder.sao_search import sao_search
        from vtm_tpu_torch.ops import sao as SAOOP

        cfg = self.cfg
        dcs = self.dcs
        n_ctu = dcs.pic_w_ctu * dcs.pic_h_ctu
        shim.sao_params = [SaoParams() for _ in range(n_ctu)]
        if cfg.sao:
            est_ctx = ContextModels()
            est_ctx.init(self.frame_qp, int(slice_type))
            est = BitEstimator(est_ctx)
            sao_search(dcs, shim, self.src, self.lam, est)
            # port: SAO on self.device (reference L377)
            SAOOP.sao_picture(dcs, shim, self.device)
        alf_on = getattr(cfg, "alf", False)
        if alf_on:
            # ALF param search + exact integer application on the
            # post-SAO reconstruction (EncGOP.cpp:2918 ALFProcess slot)
            from vtm_tpu.encoder.alf_search import alf_search
            from vtm_tpu.encoder.vlc_writer import write_aps_alf
            from vtm_tpu_torch.ops import alf as ALFOP

            pre_alf_luma = (shim.planes[0].copy()
                            if getattr(cfg, "ccalf", False) else None)
            param = alf_search(dcs, shim, self.src, self.lam)
            if param is not None:
                # port: ALF on self.device (reference L390)
                ALFOP.alf_picture(dcs, shim, self.device)
                if pre_alf_luma is not None and dcs.sh.alf_enabled[0]:
                    # CC-ALF trains against the post-ALF chroma with the
                    # pre-ALF (post-SAO) luma as filter input
                    from vtm_tpu.encoder.alf_search import derive_ccalf

                    derive_ccalf(dcs, shim, self.src, self.lam,
                                 pre_alf_luma, param)
                self._alf_aps_nal = write_aps_alf(param, aps_id=0)
            else:
                n = dcs.pic_w_ctu * dcs.pic_h_ctu
                shim.alf_ctb_flag = [np.zeros(n, dtype=np.int64) for _ in range(3)]
                shim.alf_ctb_filter_index = np.zeros(n, dtype=np.int64)
                shim.alf_ctb_alt = [np.zeros(n, dtype=np.int64) for _ in range(3)]
        # final write pass: sao params + replayed coding trees
        ctx_m = ContextModels()
        ctx_m.init(self.frame_qp, int(slice_type))
        bw = BitWriter()
        enc = BinEncoder(bw, ctx_m)
        enc.start()
        w_ctu, h_ctu = dcs.pic_w_ctu, dcs.pic_h_ctu
        substreams = []
        wpp_ctx = None
        rep_ctx = CuCtx(self.frame_qp)
        for cy in range(h_ctu):
            if cfg.wpp and cy > 0:
                # start a fresh substream, synced from the above row's
                # post-first-CTU context (DecSlice.cpp:186-210 mirror)
                ctx_m = wpp_ctx.copy()
                bw = BitWriter()
                enc = BinEncoder(bw, ctx_m)
                enc.start()
            if cfg.wpp and hasattr(dcs, "motion_lut"):
                dcs.motion_lut.clear()
                dcs.motion_lut_ibc.clear()
            for cx in range(w_ctu):
                rect = Rect(cx * cfg.ctu_size, cy * cfg.ctu_size,
                            cfg.ctu_size, cfg.ctu_size)
                writer = SyntaxWriter(dcs, enc)
                writer.sao(rect, shim.sao_params[cy * w_ctu + cx])
                if alf_on:
                    writer.alf_ctb(rect, cy * w_ctu + cx, shim)
                self._split_map = self._ctu_split_maps[(rect.x, rect.y)]
                wpart = P.Partitioner(dcs)
                wpart.init_ctu(rect, D.CH_L)
                self._replay_node(writer, wpart, rep_ctx)
                if cfg.wpp and cx == 0:
                    wpp_ctx = ctx_m.copy()
                if cx == w_ctu - 1 and (cfg.wpp or cy == h_ctu - 1):
                    enc.encode_bin_trm(1)
            if cfg.wpp:
                enc.finish()
                bw.write_byte_alignment()
                substreams.append(bw.data())
        if not cfg.wpp:
            enc.finish()
            bw.write_byte_alignment()
            return bw, None
        out = BitWriter()
        for sub in substreams:
            for b in sub:
                out.u(b, 8)
        return out, [len(sub) for sub in substreams[:-1]]
