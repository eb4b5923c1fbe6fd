"""CU reconstruction from parsed syntax (intra path).

Behavioral equivalent of DecoderLib/DecCu.cpp decompressCtu:102 /
xReconIntraQT:454 / xIntraRecBlk:173 plus TrQuant::xIT dispatch
(getTrTypes:695) and the LFNST inverse (xInvLfnst:270).  Operates on the
numpy reconstruction planes of the current picture.

The reconstructor holds an explicit torch device: finish_slice plans every
translational MC of the slice on one McBatch (ops/mc_kernel.py), runs it as
one kernel call per component class, then the DMVR and BDOF CUs batched
(decoder/refine.py), then reconstructs CUs on the host in coding order.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from vtm_tpu_torch import trace
from vtm_tpu_torch.common import rom
from vtm_tpu_torch.decoder import cs as D
from vtm_tpu_torch.decoder.cs import CH_C, CH_L, CU, MODE_INTRA, Rect, TREE_C, TU
from vtm_tpu_torch.ops import intra as I
from vtm_tpu_torch.ops import quant as Q
from vtm_tpu_torch.ops import transform as TX

BDPCM_IDX = 100  # internal marker


class _RefGeometry(NamedTuple):
    """A reference-sample fill's positions relative to the block's top-left,
    in the reference's order (xFillReferenceSamples): one position a unit
    (below-left and left from the bottom up, the corner, above and
    above-right), and each sample of the line in scan order (the left
    column from the bottom up, the corner with `mrl` samples each way, the
    above row) with its unit."""

    unit_dx: np.ndarray
    unit_dy: np.ndarray
    line_dx: np.ndarray
    line_dy: np.ndarray
    line_unit: np.ndarray
    line_pos: np.ndarray
    corner: int  # the corner sample's index in the line


@functools.lru_cache(maxsize=4096)
def _ref_geometry(w: int, h: int, unit_w: int, unit_h: int, pred_size: int,
                  pred_hsize: int, mrl: int) -> _RefGeometry:
    total_above = (pred_size + unit_w - 1) // unit_w
    total_left = (pred_hsize + unit_h - 1) // unit_h
    num_above = max(w // unit_w, 1)
    num_left = max(h // unit_h, 1)
    left_dy = np.concatenate([unit_h * np.arange(num_left),
                              h + unit_h * np.arange(total_left - num_left)])
    above_dx = np.concatenate([unit_w * np.arange(num_above),
                               w + unit_w * np.arange(total_above - num_above)])
    unit_dx = np.concatenate([np.full(total_left + 1, -1), above_dx])
    unit_dy = np.concatenate([left_dy[::-1], np.full(total_above + 1, -1)])
    corner = pred_hsize + mrl
    n = corner + 1 + pred_size + mrl
    pos = np.arange(n)
    line_dx = np.where(pos < corner, -1 - mrl, pos - corner - 1 - mrl)
    line_dy = np.where(pos < corner, corner - pos - 1 - mrl, -1 - mrl)
    counts = [pred_hsize - unit_h * (total_left - 1)] + [unit_h] * (total_left - 1) \
        + [2 * mrl + 1] + [unit_w] * (total_above - 1) \
        + [pred_size - unit_w * (total_above - 1)]
    line_unit = np.repeat(np.arange(total_left + total_above + 1), counts)
    arrays = (unit_dx, unit_dy, line_dx, line_dy, line_unit, pos)
    for a in arrays:  # shared by every call of this geometry
        a.flags.writeable = False
    return _RefGeometry(*arrays, corner)


class CuReconstructor:
    def __init__(self, dcs: D.DecCodingStructure, planes: list[np.ndarray],
                 device: torch.device):
        self.device = device
        self.cs = dcs
        self.sps = dcs.sps
        self.planes = planes
        h, w = planes[0].shape
        self.decomp_l = np.zeros(((h + 3) >> 2, (w + 3) >> 2), dtype=bool)
        if len(planes) > 1:
            ch, cw = planes[1].shape
            self.decomp_c = np.zeros(((ch + 1) >> 1, (cw + 1) >> 1), dtype=bool)
        else:
            self.decomp_c = None
        self.bit_depth = dcs.sps.bit_depth
        # IBC virtual buffer (InterPrediction.cpp:229-233): g_IBCBufferSize
        # (256*128) samples wide in luma, one CTU tall, wrap-addressed
        if dcs.sps.ibc:
            ctu = dcs.sps.ctu_size
            bufw = (256 * 128) // ctu
            fmt = dcs.chroma_format
            self.ibc_buf = []
            for comp in range(fmt.num_components):
                sx = fmt.scale_x if comp else 0
                sy = fmt.scale_y if comp else 0
                self.ibc_buf.append(
                    np.full((ctu >> sy, bufw >> sx), -1, dtype=np.int32)
                )
            dcs.reset_ibc_buffer = True
        else:
            self.ibc_buf = None

    # -- decomp tracking ----------------------------------------------------

    def set_decomp(self, comp: int, b: Rect):
        if comp == 0:
            self.decomp_l[b.y >> 2 : (b.y1 + 3) >> 2, b.x >> 2 : (b.x1 + 3) >> 2] = True
        else:
            self.decomp_c[b.y >> 1 : (b.y1 + 1) >> 1, b.x >> 1 : (b.x1 + 1) >> 1] = True

    def is_decomp(self, comp: int, x: int, y: int) -> bool:
        if x < 0 or y < 0:
            return False
        if comp == 0:
            m = self.decomp_l
            if y >= self.planes[0].shape[0] or x >= self.planes[0].shape[1]:
                return False
            return bool(m[y >> 2, x >> 2])
        m = self.decomp_c
        if y >= self.planes[1].shape[0] or x >= self.planes[1].shape[1]:
            return False
        return bool(m[y >> 1, x >> 1])

    # -- top level ----------------------------------------------------------

    def derive_cus(self, cus: list[CU]):
        """Parse-phase pass: MV derivation + HMVP updates in exact CU order
        (sample-independent — DecCu::xDeriveCUMV semantics).  Sample
        reconstruction is deferred to finish_slice() so all inter MC of the
        slice can run as batched device kernels."""
        from vtm_tpu_torch.decoder import inter_cu
        from vtm_tpu_torch.decoder import motion as M

        ibc = self.cs.sps.ibc
        for cu in cus:
            if ibc and getattr(self.cs, "reset_ibc_buffer", False):
                cu._ibc_row_reset = True
                self.cs.reset_ibc_buffer = False
            if cu.pred_mode in (D.MODE_INTER, D.MODE_IBC):
                inter_cu.derive_cu_mv(self.cs, cu)
                M.save_motion_hmvp(self.cs, cu)
        if not hasattr(self, "_pending"):
            self._pending = []
        self._pending.extend(cus)

    def finish_slice(self):
        """Deferred sample reconstruction: batch-plan all inter MC of the
        slice, execute the batched kernels, then walk CUs in coding order
        applying predictions/residuals (intra/IBC/PLT stay order-dependent).
        Under torch.profiler the span `recon`, with `inter.plan`,
        `inter.mc`, `inter.dmvr` and `inter.bdof` inside it and a timer a
        CU kind (trace.py)."""
        with trace.span("recon"):
            self._finish_slice()

    def _finish_slice(self):
        from vtm_tpu_torch.decoder import inter_cu
        from vtm_tpu_torch.ops.mc_kernel import McBatch

        cus = getattr(self, "_pending", [])
        self._pending = []
        batch = McBatch(self.bit_depth, self.device)
        fins = {}
        dmvr_jobs = []
        bdof_cus = []
        ref_results = {}
        with trace.span("inter.plan"):
            for cu in cus:
                if cu.pred_mode in (D.MODE_INTER, D.MODE_IBC):
                    p = inter_cu.plan_cu_mc(batch, self, cu)
                    if isinstance(p, tuple):
                        if p[0] == "dmvr":
                            dmvr_jobs.append((cu, p[1]))
                        else:
                            bdof_cus.append(cu)
                        p = (lambda c=cu: ref_results[id(c)])
                    fins[id(cu)] = p
        batch.execute()
        if dmvr_jobs or bdof_cus:
            from vtm_tpu_torch.decoder import refine

            if dmvr_jobs:
                with trace.span("inter.dmvr"):
                    ref_results.update(refine.dmvr_batch(self, self.cs, dmvr_jobs))
            if bdof_cus:
                with trace.span("inter.bdof"):
                    ref_results.update(refine.bdof_batch(self, self.cs, bdof_cus))
        ibc = self.cs.sps.ibc
        for cu in cus:
            if ibc:
                if getattr(cu, "_ibc_row_reset", False):
                    for b in self.ibc_buf:
                        b.fill(-1)
                if cu.blocks[0] is not None:
                    self._ibc_vpdu_reset(cu)
            if cu.pred_mode == MODE_INTRA:
                with trace.timer("recon.intra"):
                    self.recon_intra_cu(cu)
            elif cu.pred_mode in (D.MODE_INTER, D.MODE_IBC):
                with trace.timer("recon.inter"):
                    inter_cu.recon_inter_cu(self, cu, fins[id(cu)])
            else:
                with trace.timer("recon.plt"):
                    self.recon_plt_cu(cu)
            if ibc:
                self._ibc_fill_buffer(cu)

    def reconstruct_cus(self, cus: list[CU]):
        """Immediate-mode path (derive + reconstruct in one go)."""
        self.derive_cus(cus)
        self.finish_slice()

    def recon_plt_cu(self, cu: CU):
        """DecCu::xReconPLT (DecCu.cpp:502): palette colors + dequantized
        escape values, luma-begin joint writes chroma at scaled positions."""
        from vtm_tpu_torch.ops import quant as Q

        p = cu.plt
        fmt = self.cs.chroma_format
        sx, sy = fmt.scale_x, fmt.scale_y
        bd = self.bit_depth
        maxv = (1 << bd) - 1
        tu = cu.tus[0]
        for comp_begin, num_comp in p.calls:
            chb = 0 if comp_begin == 0 else 1
            idx = p.idx[chb]
            cur_size = p.cur_size[chb]
            esc_mask = idx == cur_size
            safe_idx = np.minimum(idx, max(cur_size - 1, 0))
            for c in range(comp_begin, comp_begin + num_comp):
                b = cu.blocks[c]
                if comp_begin != 0 or c == 0:
                    cidx, cesc = safe_idx, esc_mask
                    esc_vals = p.escape[c]
                else:
                    # luma-begin chroma: subsample the index map
                    cidx = safe_idx[:: 1 << sy, :: 1 << sx]
                    cesc = esc_mask[:: 1 << sy, :: 1 << sx]
                    esc_vals = p.escape[c]
                out = p.cur[c][cidx]
                if cesc.any():
                    qp, per, rem = self._qp_for(tu, c)
                    qp_ts = max(qp, 4 + 6 * self.sps.internal_minus_input_bd)
                    per, rem = qp_ts // 6, qp_ts % 6
                    scale = rom.inv_quant_scale(rem, False)
                    vals = ((esc_vals.astype(np.int64) * scale) << per) + 32
                    vals = np.clip(vals >> 6, 0, maxv).astype(np.int32)
                    out = np.where(cesc, vals, out)
                self.planes[c][b.y : b.y1, b.x : b.x1] = out
                self.set_decomp(c, b)
                if c == 0:
                    self.cs.qp_map_l[
                        b.y >> 2 : b.y1 >> 2, b.x >> 2 : b.x1 >> 2
                    ] = cu.qp

    def _ibc_vpdu_reset(self, cu: CU):
        """InterPrediction::resetVPDUforIBC (InterPrediction.cpp:2282) at
        VPDU-aligned CU starts (DecCu.cpp:121-131)."""
        ctu = self.cs.sps.ctu_size
        vsize = min(ctu, 64)
        b = cu.blocks[0]
        if b.x % vsize or b.y % vsize:
            return
        bufw = (256 * 128) // ctu
        fmt = self.cs.chroma_format
        for x in range(b.x, b.x + b.w, vsize):
            for y in range(b.y, b.y + b.h, vsize):
                rx = (x + bufw // 2) & (bufw - 1)
                ry = y & (ctu - 1)
                for comp in range(fmt.num_components):
                    sx = fmt.scale_x if comp else 0
                    sy = fmt.scale_y if comp else 0
                    self.ibc_buf[comp][
                        ry >> sy : (ry + vsize) >> sy,
                        rx >> sx : (rx + vsize) >> sx,
                    ] = -1

    def _ibc_fill_buffer(self, cu: CU):
        """InterPrediction::xFillIBCBuffer (InterPrediction.cpp:2207)."""
        ctu = self.cs.sps.ctu_size
        log2ctu = ctu.bit_length() - 1
        bufw = (256 * 128) // ctu
        fmt = self.cs.chroma_format
        for comp in range(fmt.num_components):
            b = cu.blocks[comp]
            if b is None:
                continue
            sx = fmt.scale_x if comp else 0
            sy = fmt.scale_y if comp else 0
            px = b.x & ((bufw >> sx) - 1)
            py = b.y & ((1 << (log2ctu - sy)) - 1)
            self.ibc_buf[comp][py : py + b.h, px : px + b.w] = self.planes[comp][
                b.y : b.y1, b.x : b.x1
            ]

    def recon_intra_cu(self, cu: CU):
        if cu.isp_mode and cu.blocks[0] is not None:
            self._recon_isp_luma(cu)
            last = cu.tus[-1]
            for comp in (1, 2):
                if last.blocks[comp] is not None:
                    self.intra_rec_blk(last, comp)
            return
        for tu in cu.tus:
            for comp in range(3):
                if tu.blocks[comp] is not None:
                    self.intra_rec_blk(tu, comp)

    def _recon_isp_luma(self, cu: CU, quantize_cb=None):
        """ISP luma reconstruction with incremental reference updates
        (DecCu.cpp xIntraRecBlk ISP paths + initIntraPatternChTypeISP:802).

        quantize_cb(tu, pred_tb): encoder hook invoked with each sub-TB's
        prediction before reconstruction, letting the encoder quantize the
        residual against the exact decoder-side prediction chain."""
        cb = cu.blocks[0]
        horizontal = cu.isp_mode == 1
        maxv = (1 << self.bit_depth) - 1
        mode = self._final_intra_mode(cu, 0)
        pred_reg_diff = (not horizontal) and (
            (cb.w == 8 and cb.h > 4) or cb.w == 4
        )
        top = left = None
        pred_cache: np.ndarray | None = None  # (h, 4) for current pred region
        pred_cache_x0 = -1
        for tu in cu.tus:
            b = tu.blocks[0]
            if b is None:
                continue
            area_w, area_h = b.w, b.h
            if pred_reg_diff:
                first_in_reg = ((b.x - cb.x) % 4) == 0
                adj_w = max(4, area_w)
            else:
                first_in_reg = True
                adj_w = area_w
            do_ref_update = first_in_reg
            if do_ref_update:
                pred_w = adj_w if pred_reg_diff else area_w
                top_len = cb.w + pred_w
                left_len = cb.h + area_h
                if b.x == cb.x and b.y == cb.y:
                    # first sub-TU: fetch all CU reference samples at once
                    if horizontal:
                        fill_top_len, fill_left_len = cb.w + area_w, cb.h * 2
                    else:
                        fill_top_len, fill_left_len = cb.w * 2, cb.h + area_h
                    top, left = self._fill_ref_lengths(
                        cb, cu, 0, 0, fill_top_len, fill_left_len
                    )
                else:
                    is_left_avail = (
                        self.cs.get_cu_restricted(b.x - 1, b.y, b.x, b.y, 0) is not None
                        and self.is_decomp(0, b.x - 1, b.y)
                    )
                    is_above_avail = (
                        self.cs.get_cu_restricted(b.x, b.y - 1, b.x, b.y, 0) is not None
                        and self.is_decomp(0, b.x, b.y - 1)
                    )
                    plane = self.planes[0]
                    if horizontal:
                        # shift left refs up by area_h, rebuild top from recon
                        if is_left_avail:
                            for i in range(2 * cb.h - area_h + 1):
                                left[i] = left[i + area_h]
                        else:
                            fill = int(plane[b.y - 1, b.x])
                            for i in range(left_len + 1):
                                left[i] = fill
                        top = np.zeros(top_len + 2, dtype=np.int64)
                        top[0] = left[0]
                        for i in range(area_w):
                            top[1 + i] = int(plane[b.y - 1, b.x + i])
                        sample = int(plane[b.y - 1, b.x + area_w - 1])
                        for i in range(top_len - area_w):
                            top[1 + area_w + i] = sample
                    else:
                        if is_above_avail:
                            for i in range(2 * cb.w - pred_w + 1):
                                top[i] = top[i + pred_w]
                        else:
                            fill = int(plane[b.y, b.x - 1])
                            top = np.zeros(max(len(top), top_len + 2), dtype=np.int64)
                            for i in range(top_len + 1):
                                top[i] = fill
                        left = np.zeros(left_len + 2, dtype=np.int64)
                        left[0] = top[0]
                        for i in range(area_h):
                            left[1 + i] = int(plane[b.y + i, b.x - 1])
                        sample = int(plane[b.y + area_h - 1, b.x - 1])
                        for i in range(left_len - area_h):
                            left[1 + area_h + i] = sample
                # prediction over (pred_w x area_h)
                pred_w = adj_w
                p = I.IntraParams(
                    dir_mode=mode, pu_w=pred_w, pu_h=area_h, cu_w=cb.w, cu_h=cb.h,
                    is_luma=True, multi_ref_idx=0, use_isp=True, bdpcm=bool(cu.bdpcm_mode),
                )
                if cu.bdpcm_mode:
                    pred = I.pred_bdpcm(top, left, pred_w, area_h, cu.bdpcm_mode, self.bit_depth)
                elif mode == D.PLANAR_IDX:
                    pred = I.pred_planar(top, left, pred_w, area_h)
                    if p.apply_pdpc:
                        pred = I.pdpc_planar_dc(pred, top, left)
                elif mode == D.DC_IDX:
                    dc = I.pred_dc(top, left, pred_w, area_h, 0)
                    pred = np.full((area_h, pred_w), dc, dtype=np.int64)
                    if p.apply_pdpc:
                        pred = I.pdpc_planar_dc(pred, top, left)
                else:
                    pred = I.pred_angular(
                        top, left, pred_w, area_h, p, True, self.bit_depth,
                        top_ref_len=cb.w + pred_w, left_ref_len=cb.h + area_h,
                    )
                pred_cache = pred
                pred_cache_x0 = b.x
            # residual + recon for this TB
            off = b.x - pred_cache_x0
            pred_tb = pred_cache[:, off : off + b.w]
            if quantize_cb is not None:
                quantize_cb(tu, pred_tb)
            if tu.cbf[0]:
                resi = self._inv_tx_one(tu, 0)
            else:
                resi = np.zeros((b.h, b.w), dtype=np.int32)
            recon = np.clip(pred_tb + resi, 0, maxv).astype(np.int32)
            self.planes[0][b.y : b.y1, b.x : b.x1] = recon
            self.set_decomp(0, b)
            self.cs.qp_map_l[b.y >> 2 : b.y1 >> 2, b.x >> 2 : b.x1 >> 2] = cu.qp
        # whole-CU decomp (reference marks full CU luma on first ISP TU)
        self.set_decomp(0, cb)

    # -- per-block ----------------------------------------------------------

    def _final_intra_mode(self, cu: CU, comp: int) -> int:
        ch = 0 if comp == 0 else 1
        mode = cu.intra_dir[ch]
        if ch == 1 and mode == D.DM_CHROMA_IDX:
            # co-located luma mode
            b = cu.blocks[1]
            fmt = self.cs.chroma_format
            if cu.is_sep_tree:
                lx = (b.x + (b.w >> 1)) << fmt.scale_x
                ly = (b.y + (b.h >> 1)) << fmt.scale_y
            else:
                lx = b.x << fmt.scale_x
                ly = b.y << fmt.scale_y
            luma = self.cs.get_cu(lx, ly, CH_L)
            mode = D.PLANAR_IDX if (luma is None or luma.mip_flag) else luma.intra_dir[0]
        return mode

    def fill_reference_samples(self, tu_b: Rect, cu: CU, comp: int, mrl: int):
        """xFillReferenceSamples → (top, left) arrays (see ops.intra docs)."""
        return self._fill_ref_lengths(tu_b, cu, comp, mrl, tu_b.w * 2, tu_b.h * 2)

    def _fill_ref_lengths(self, tu_b: Rect, cu: CU, comp: int, mrl: int,
                          pred_size: int, pred_hsize: int):
        plane = self.planes[comp]
        ph, pw = plane.shape
        w, h = tu_b.w, tu_b.h
        fmt = self.cs.chroma_format
        unit_w = 4 >> (fmt.scale_x if comp else 0)
        unit_h = 4 >> (fmt.scale_y if comp else 0)
        if w <= 2 and cu.isp_mode and comp == 0:
            unit_w = w
        if h <= 2 and cu.isp_mode and comp == 0:
            unit_h = h
        g = _ref_geometry(w, h, unit_w, unit_h, pred_size, pred_hsize, mrl)
        x0, y0 = tu_b.x, tu_b.y
        flags = self._available(comp, x0 + g.unit_dx, y0 + g.unit_dy, x0, y0)
        num_intra = int(np.count_nonzero(flags))
        top = np.zeros(pred_size + mrl + 2, dtype=np.int64)
        left = np.zeros(pred_hsize + mrl + 2, dtype=np.int64)
        if num_intra == 0:
            dc_val = 1 << (self.bit_depth - 1)
            top[: pred_size + mrl + 1] = dc_val
            left[: pred_hsize + mrl + 1] = dc_val
            return top, left
        # the reads: the left column from the bottom up, the corner, the
        # above row, at clamped coordinates
        line = plane[np.minimum(np.maximum(y0 + g.line_dy, 0), ph - 1),
                     np.minimum(np.maximum(x0 + g.line_dx, 0), pw - 1)]
        if num_intra < len(flags):
            trace.count("intra.ref_partial")
            # the padding, in that scan order: each unavailable sample takes
            # the last available one before it, the leading run the first
            avail = flags[g.line_unit]
            line = line[np.maximum.accumulate(
                np.where(avail, g.line_pos, avail.argmax()))]
        top[: pred_size + mrl + 1] = line[g.corner:]
        left[: pred_hsize + mrl + 1] = line[g.corner :: -1]
        return top, left

    def _available(self, comp: int, xs: np.ndarray, ys: np.ndarray,
                   x0: int, y0: int) -> np.ndarray:
        """Whether each position (xs, ys) of component `comp` is
        reconstructed and may be referenced from the block at (x0, y0):
        is_decomp and cs.get_cu_restricted over all positions at once."""
        cs = self.cs
        ph, pw = self.planes[comp].shape
        # negative coordinates wrap to huge ones as unsigned
        inside = (xs.view(np.uint64) < pw) & (ys.view(np.uint64) < ph)
        xs, ys = xs[inside], ys[inside]
        if comp == 0:
            sx = sy = 0
            at = (ys >> 2, xs >> 2)
            decomp, cu_idx = self.decomp_l[at], cs.map_l[at]
        else:
            sx, sy = cs.chroma_format.scale_x, cs.chroma_format.scale_y
            at = (ys >> 1, xs >> 1)
            decomp, cu_idx = self.decomp_c[at], cs.map_c[at]
        ok = decomp & (cu_idx >= 0)
        ok &= cs.cu_slice[cu_idx] == cs.cur_slice_idx
        ok &= cs.cu_tile[cu_idx] == cs.tile_idx_at(x0 << sx, y0 << sy)
        if cs.sps.entropy_coding_sync:
            log2_ctu = cs.sps.log2_ctu_size
            ok &= ((xs << sx) >> log2_ctu) <= ((x0 << sx) >> log2_ctu)
        flags = np.zeros(len(inside), dtype=bool)
        flags[inside] = ok
        return flags

    def intra_rec_blk(self, tu: TU, comp: int):
        cu = tu.cu
        b = tu.blocks[comp]
        is_luma = comp == 0
        ch = 0 if is_luma else 1
        mode = self._final_intra_mode(cu, comp)
        bdpcm = cu.bdpcm_mode if is_luma else cu.bdpcm_mode_chroma
        if cu.isp_mode and is_luma:
            raise NotImplementedError("ISP recon")
        if cu.mip_flag and is_luma:
            trace.count("intra.mip")
            top, left = self.fill_reference_samples(b, cu, comp, 0)
            pred = I.pred_mip(
                top[1 : b.w + 1], left[1 : b.h + 1], b.w, b.h,
                cu.intra_dir[0], cu.mip_transposed, self.bit_depth,
            )
            resi = self.inv_transform(tu, comp)
            maxv = (1 << self.bit_depth) - 1
            recon = np.clip(pred + resi, 0, maxv).astype(np.int32)
            self.planes[comp][b.y : b.y1, b.x : b.x1] = recon
            self.set_decomp(comp, b)
            self.cs.qp_map_l[b.y >> 2 : b.y1 >> 2, b.x >> 2 : b.x1 >> 2] = cu.qp
            return
        if not is_luma and mode in (D.LM_CHROMA_IDX, D.MDLM_L_IDX, D.MDLM_T_IDX):
            pred = self._pred_cclm(tu, comp, mode)
            resi = self.inv_transform(tu, comp)
            resi = self._maybe_scale_chroma_resi(tu, comp, resi)
            maxv = (1 << self.bit_depth) - 1
            recon = np.clip(pred + resi, 0, maxv).astype(np.int32)
            self.planes[comp][b.y : b.y1, b.x : b.x1] = recon
            self.set_decomp(comp, b)
            return
        mrl = cu.multi_ref_idx if is_luma else 0
        p = I.IntraParams(
            dir_mode=mode,
            pu_w=b.w,
            pu_h=b.h,
            cu_w=cu.blocks[comp].w if cu.blocks[comp] else b.w,
            cu_h=cu.blocks[comp].h if cu.blocks[comp] else b.h,
            is_luma=is_luma,
            multi_ref_idx=mrl,
            use_isp=bool(cu.isp_mode),
            bdpcm=bool(bdpcm),
        )
        top, left = self.fill_reference_samples(b, cu, comp, mrl)
        if p.ref_filter_flag:
            ftop, fleft = I.filter_reference_samples(top, left, b.w * 2, b.h * 2, mrl)
        else:
            ftop, fleft = top, left
        if bdpcm:
            pred = I.pred_bdpcm(top, left, b.w, b.h, bdpcm, self.bit_depth)
        elif mode == D.PLANAR_IDX:
            pred = I.pred_planar(ftop, fleft, b.w, b.h)
            if p.apply_pdpc:
                pred = I.pdpc_planar_dc(pred, ftop, fleft)
        elif mode == D.DC_IDX:
            dc = I.pred_dc(top, left, b.w, b.h, p.multi_ref_idx)
            pred = np.full((b.h, b.w), dc, dtype=np.int64)
            if p.apply_pdpc:
                pred = I.pdpc_planar_dc(pred, top, left)
        else:
            use_top, use_left = (ftop, fleft) if p.ref_filter_flag else (top, left)
            pred = I.pred_angular(
                use_top, use_left, b.w, b.h, p, is_luma, self.bit_depth
            )
        # residual
        resi = self.inv_transform(tu, comp)
        resi = self._maybe_scale_chroma_resi(tu, comp, resi)
        maxv = (1 << self.bit_depth) - 1
        recon = np.clip(pred + resi, 0, maxv).astype(np.int32)
        self.planes[comp][b.y : b.y1, b.x : b.x1] = recon
        self.set_decomp(comp, b)
        # record qp for deblocking
        if comp == 0:
            self.cs.qp_map_l[b.y >> 2 : b.y1 >> 2, b.x >> 2 : b.x1 >> 2] = cu.qp

    def _maybe_scale_chroma_resi(self, tu: TU, comp: int, resi: np.ndarray) -> np.ndarray:
        """LMCS chroma residual scaling (DecCu xIntraRecBlk + Reshape)."""
        if comp == 0:
            return resi
        sh = self.cs.sh
        ph = self.cs.ph
        lmcs = getattr(self.cs, "lmcs_model", None)
        if lmcs is None or not sh.lmcs_enabled or not ph.lmcs_chroma_residual_scale:
            return resi
        if not (tu.cbf[1] or tu.cbf[2]):
            return resi
        if not hasattr(tu, "_chroma_adj"):
            tu._chroma_adj = self._chroma_adj_vpdu(tu)
        b = tu.blocks[comp]
        if b.w * b.h > 4 and (tu.cbf[comp] or tu.joint_cbcr):
            from vtm_tpu_torch.ops import lmcs as L

            return L.scale_signal_inverse(resi, tu._chroma_adj, self.bit_depth)
        return resi

    def _chroma_adj_vpdu(self, tu: TU) -> int:
        """Reshape::calculateChromaAdjVpduNei (Reshape.cpp:106)."""
        lmcs = self.cs.lmcs_model
        fmt = self.cs.chroma_format
        if tu.blocks[0] is not None:
            ax, ay = tu.blocks[0].x, tu.blocks[0].y
        else:
            ax = tu.blocks[1].x << fmt.scale_x
            ay = tu.blocks[1].y << fmt.scale_y
        ctu = self.sps.ctu_size
        num_neighbor = min(64, ctu)
        nlog = num_neighbor.bit_length() - 1
        grid = 64 if ctu == 128 else ctu
        x_pos = ax // grid * grid
        y_pos = ay // grid * grid
        cache = getattr(self, "_vpdu_cache", None)
        if cache is not None and cache[0] == x_pos and cache[1] == y_pos:
            return cache[2]
        top_left_luma = self.cs.get_cu(x_pos, y_pos, CH_L)
        lx, ly = top_left_luma.lx, top_left_luma.ly
        cu_above = self.cs.get_cu_restricted(lx, ly - 1, lx, ly, CH_L)
        cu_left = self.cs.get_cu_restricted(lx - 1, ly, lx, ly, CH_L)
        plane = self.planes[0]
        pic_h, pic_w = plane.shape
        rec_sum = 0
        pelnum = 0
        if cu_left is not None:
            for i in range(num_neighbor):
                k = (pic_h - ly - 1) if (ly + i) >= pic_h else i
                rec_sum += int(plane[ly + k, lx - 1])
                pelnum += 1
        if cu_above is not None:
            for i in range(num_neighbor):
                k = (pic_w - lx - 1) if (lx + i) >= pic_w else i
                rec_sum += int(plane[ly - 1, lx + k])
                pelnum += 1
        if pelnum == num_neighbor:
            luma_value = (rec_sum + (1 << (nlog - 1))) >> nlog
        elif pelnum == (num_neighbor << 1):
            luma_value = (rec_sum + (1 << nlog)) >> (nlog + 1)
        else:
            luma_value = 1 << (self.bit_depth - 1)
        adj = lmcs.chroma_adj(luma_value)
        self._vpdu_cache = (x_pos, y_pos, adj)
        return adj

    def _avail_units(self, comp: int, b: Rect, direction: str, num_units: int,
                     unit: int) -> tuple[int, list[bool]]:
        """is{Left,Above,BelowLeft,AboveRight}Available — contiguous-decomp
        walk; returns (count, flags)."""
        ch = 0 if comp == 0 else 1
        flags = []
        count = 0
        for i in range(num_units):
            if direction == "left":
                px, py = b.x - 1, b.y + i * unit
            elif direction == "above":
                px, py = b.x + i * unit, b.y - 1
            elif direction == "belowleft":
                px, py = b.x - 1, b.y1 + i * unit
            else:  # aboveright
                px, py = b.x1 + i * unit, b.y - 1
            if not self.is_decomp(comp, px, py):
                break
            ok = self.cs.get_cu_restricted(px, py, b.x, b.y, ch) is not None
            flags.append(ok)
            count += int(ok)
        return count, flags

    def _pred_cclm(self, tu: TU, comp: int, mode: int) -> np.ndarray:
        cu = tu.cu
        b = tu.blocks[comp]
        fmt = self.cs.chroma_format
        sx, sy = fmt.scale_x, fmt.scale_y
        lx, ly = b.x << sx, b.y << sy
        unit_w = 4 >> sx
        unit_h = 4 >> sy
        n_above = b.w // unit_w
        n_left = b.h // unit_h
        total_above = (2 * b.w + unit_w - 1) // unit_w
        total_left = (2 * b.h + unit_h - 1) // unit_h
        cnt_above, _ = self._avail_units(comp, b, "above", n_above, unit_w)
        above_avail = cnt_above == n_above
        cnt_left, _ = self._avail_units(comp, b, "left", n_left, unit_h)
        left_avail = cnt_left == n_left
        avai_ar = 0
        avai_bl = 0
        if above_avail:
            avai_ar, _ = self._avail_units(comp, b, "aboveright", total_above - n_above, unit_w)
        if left_avail:
            avai_bl, _ = self._avail_units(comp, b, "belowleft", total_left - n_left, unit_h)
        mdlm = mode in (D.MDLM_L_IDX, D.MDLM_T_IDX)
        added_ar = avai_ar * unit_w if mdlm else 0
        added_bl = avai_bl * unit_h if mdlm else 0
        first_row = (ly & (self.sps.ctu_size - 1)) == 0
        collocated = self.sps.chroma_ver_collocated if fmt.value == 1 else True
        inner, l_top, l_left = I.cclm_downsample_luma(
            self.planes[0], lx, ly, b.w, b.h, sx, sy,
            above_avail, left_avail, first_row, collocated, added_ar, added_bl,
        )
        # chroma reference samples (unfiltered)
        c_top, c_left = self.fill_reference_samples(b, cu, comp, 0)
        mode_name = {D.LM_CHROMA_IDX: "lm", D.MDLM_L_IDX: "mdlm_l", D.MDLM_T_IDX: "mdlm_t"}[mode]
        a, off, shift = I.cclm_parameters(
            mode_name, b.w, b.h, l_top, l_left, c_top, c_left,
            above_avail, left_avail, avai_ar, avai_bl, unit_w, unit_h, self.bit_depth,
        )
        maxv = (1 << self.bit_depth) - 1
        return np.clip(((a * inner) >> shift) + off, 0, maxv)

    # -- residual -----------------------------------------------------------

    def _tr_types(self, tu: TU, comp: int) -> tuple[int, int]:
        cu = tu.cu
        sps = self.sps
        is_intra = cu.pred_mode == MODE_INTRA
        is_explicit = comp == 0 and (
            sps.explicit_mts_intra if is_intra else (sps.explicit_mts_inter and cu.pred_mode == D.MODE_INTER)
        )
        is_implicit = (
            is_intra and sps.mts and not sps.explicit_mts_intra and comp == 0
            and cu.lfnst_idx == 0 and not cu.mip_flag
        )
        is_isp = is_intra and bool(cu.isp_mode) and comp == 0
        is_sbt = cu.pred_mode == D.MODE_INTER and cu.sbt_info and comp == 0
        tr_h = tr_v = TX.DCT2
        if is_isp and cu.lfnst_idx:
            return tr_h, tr_v
        if not sps.mts:
            return tr_h, tr_v
        if is_implicit or is_isp:
            b = tu.blocks[comp]
            if 4 <= b.w <= 16:
                tr_h = TX.DST7
            if 4 <= b.h <= 16:
                tr_v = TX.DST7
            return tr_h, tr_v
        if is_sbt:
            # TrQuant::getTrTypes SBT branch (TrQuant.cpp:728)
            sbt_idx = cu.sbt_info & 0xF
            sbt_pos = (cu.sbt_info >> 4) & 0x3
            b = tu.blocks[0]
            if sbt_idx in (1, 3):  # VER_HALF / VER_QUAD
                if b.h > 32:  # MTS_INTER_MAX_CU_SIZE
                    return TX.DCT2, TX.DCT2
                if sbt_pos == 0:
                    return TX.DCT8, TX.DST7
                return TX.DST7, TX.DST7
            if b.w > 32:
                return TX.DCT2, TX.DCT2
            if sbt_pos == 0:
                return TX.DST7, TX.DCT8
            return TX.DST7, TX.DST7
        if is_explicit and tu.mts_idx[comp] > D.MTS_SKIP:
            ind_h = (tu.mts_idx[comp] - D.MTS_DST7_DST7) & 1
            ind_v = (tu.mts_idx[comp] - D.MTS_DST7_DST7) >> 1
            tr_h = TX.DCT8 if ind_h else TX.DST7
            tr_v = TX.DCT8 if ind_v else TX.DST7
        return tr_h, tr_v

    def _qp_for(self, tu: TU, comp: int) -> tuple[int, int, int]:
        cu = tu.cu
        sh = self.cs.sh
        use_jqp = abs(self._ict_mode(tu)) == 2 if comp != 0 else False
        adj_offsets = (0, 0, 0)
        if cu.chroma_qp_adj and self.cs.pps.chroma_qp_offset_list:
            adj_offsets = self.cs.pps.chroma_qp_offset_list[cu.chroma_qp_adj - 1]
        return Q.qp_param(
            cu.qp,
            comp,
            self.sps,
            sh.cb_qp_offset,
            sh.cr_qp_offset,
            sh.joint_cbcr_qp_offset,
            adj_offsets,
            use_jqp,
        )

    def _ict_mode(self, tu: TU) -> int:
        if tu.joint_cbcr == 0:
            return 0
        sign = 1 if self.cs.ph.joint_cbcr_sign else 0
        return Q.G_ICT_MODES[sign][tu.joint_cbcr]

    def inv_transform(self, tu: TU, comp: int) -> np.ndarray:
        """invTransformNxN + joint CbCr handling; returns (h, w) residual."""
        cu = tu.cu
        b = tu.blocks[comp]
        if tu.joint_cbcr and comp != 0:
            if comp == 1:
                mode = self._ict_mode(tu)
                if tu.joint_cbcr >> 1:
                    res1 = self._inv_tx_one(tu, 1)
                else:
                    res1 = self._inv_tx_one(tu, 2)
                cb, cr = Q.inv_transform_ict(mode, res1, res1.copy())
                tu._joint_cr = cr
                return cb
            return tu._joint_cr
        if not tu.cbf[comp]:
            return np.zeros((b.h, b.w), dtype=np.int32)
        return self._inv_tx_one(tu, comp)

    def _scaling_for(self, tu: TU, comp: int, qp_rem: int):
        """Explicit scaling-list dequant matrix for this TB, or None
        (Quant::dequant gates, Quant.cpp:373-377 getUseScalingList)."""
        sl = getattr(self.cs, "scaling_list", None)
        if sl is None:
            return None
        cu = tu.cu
        sps = self.sps
        # isLfnstApplied (Quant.cpp:374): separate-tree chroma CUs apply
        # LFNST to their chroma TBs; joint-tree CUs only to luma.  Our
        # chroma-only CUs are identified by ch_type (tree_type stays
        # TREE_D in the global dual tree).
        lfnst_applied = cu.lfnst_idx > 0 and (
            comp == 0 or cu.ch_type == D.CH_C)
        if lfnst_applied and getattr(
                sps, "scaling_matrix_for_lfnst_disabled", False):
            return None
        if getattr(sps, "scaling_matrix_alt_colour_disabled", False) and \
                getattr(sps, "scaling_matrix_designated_colour", False) == \
                bool(getattr(cu, "color_transform", False)):
            return None
        from vtm_tpu_torch.decoder import scaling_list as _scl

        b = tu.blocks[comp]
        lt = _scl.scaling_list_type(cu.pred_mode == D.MODE_INTRA, comp)
        return _scl.dequant_matrix(sl, lt, qp_rem, b.w, b.h)

    def _inv_tx_one(self, tu: TU, comp: int) -> np.ndarray:
        cu = tu.cu
        b = tu.blocks[comp]
        qp = self._qp_for(tu, comp)
        sh = self.cs.sh
        if tu.mts_idx[comp] == D.MTS_SKIP:
            # TS path: QpPrimeTsMin clamp, per-mode dequant, no transform
            bdpcm = cu.bdpcm_mode if comp == 0 else cu.bdpcm_mode_chroma
            coeffs = tu.coeffs[comp]
            if bdpcm:
                coeffs = self._inv_res_dpcm(coeffs, bdpcm)
            qp_ts_v = max(qp[0], 4 + 6 * self.sps.internal_minus_input_bd)
            qp_ts = (qp_ts_v, qp_ts_v // 6, qp_ts_v % 6)
            use_regular_ts = sh.ts_residual_coding_disabled
            if sh.dep_quant and use_regular_ts:
                scan = rom.scan(1, b.w, b.h)
                return Q.dequant_dep(coeffs, qp_ts, self.bit_depth, scan, is_ts=True)
            return Q.dequant(coeffs, qp_ts, self.bit_depth, is_ts=True)
        use_regular = sh.ts_residual_coding_disabled or tu.mts_idx[comp] != D.MTS_SKIP
        if sh.dep_quant and use_regular:
            # dep-quant matrices are indexed by the DQ qp (+1) remainder
            # (DepQuant.cpp:1616-1631)
            scaling = self._scaling_for(tu, comp, (qp[0] + 1) % 6)
            scan = rom.scan(1, b.w, b.h)
            deq = Q.dequant_dep(tu.coeffs[comp], qp, self.bit_depth, scan,
                                scaling=scaling)
        else:
            scaling = self._scaling_for(tu, comp, qp[2])
            deq = Q.dequant(tu.coeffs[comp], qp, self.bit_depth,
                            scaling=scaling)
        if cu.lfnst_idx:
            deq = self.inv_lfnst(tu, comp, deq)
        tr_h, tr_v = self._tr_types(tu, comp)
        return TX.inv_transform_2d_np(deq, self.bit_depth, tr_h, tr_v)

    @staticmethod
    def _inv_res_dpcm(coeffs: np.ndarray, bdpcm_mode: int) -> np.ndarray:
        """Quant::invResDPCM (Quant.cpp:143): cumulative sum along the BDPCM
        direction with 16-bit-range clamping."""
        out = coeffs.astype(np.int64).copy()
        h, w = out.shape
        if bdpcm_mode == 1:  # horizontal
            for x in range(1, w):
                out[:, x] = np.clip(out[:, x - 1] + out[:, x], -32768, 32767)
        else:
            for y in range(1, h):
                out[y, :] = np.clip(out[y - 1, :] + out[y, :], -32768, 32767)
        return out.astype(np.int32)

    def _lfnst_setup(self, tu: TU, comp: int, lfnst_idx: int):
        """Shared geometry/matrix derivation for the LFNST inverse
        (xInvLfnst) and the encoder-side forward (xFwdLfnst): returns
        (scan, mat, transpose, sb_size, zero_out) for this TU/component."""
        cu = tu.cu
        b = tu.blocks[comp]
        w, h = b.w, b.h
        whge3 = w >= 8 and h >= 8
        if whge3:
            scan = rom.get(f"scanTL8x8_w{w}")
        else:
            scan = rom.scan(1, w, h)
        # intra mode for transform-set selection
        ch = 0 if comp == 0 else 1
        mode = cu.intra_dir[ch]
        if ch == 1 and mode in (D.LM_CHROMA_IDX, D.MDLM_L_IDX, D.MDLM_T_IDX):
            luma = self._colocated_luma(cu)
            mode = D.PLANAR_IDX if (luma is None or luma.mip_flag) else luma.intra_dir[0]
        else:
            mode = self._final_intra_mode(cu, comp)
        if (comp == 0 and cu.mip_flag) or (
            ch == 1 and False
        ):
            mode = D.PLANAR_IDX
        # wide angle (PU::getWideAngle — ISP uses CU dims)
        if mode >= 2:
            if cu.isp_mode and comp == 0:
                aw, ah = cu.blocks[0].w, cu.blocks[0].h
            else:
                aw, ah = w, h
            mode_shift = [0, 6, 10, 12, 14, 15]
            delta = abs(I.floor_log2(aw) - I.floor_log2(ah))
            if aw > ah and mode < 2 + mode_shift[delta]:
                mode += D.VDIA_IDX - 1
            elif ah > aw and mode > D.VDIA_IDX - mode_shift[delta]:
                mode -= D.VDIA_IDX + 1
        # getLFNSTIntraMode
        if mode < 0:
            intra_mode = mode + 14 + D.NUM_LUMA_MODE  # NUM_EXT_LUMA_MODE>>1 = 14
        elif mode >= D.NUM_LUMA_MODE:
            intra_mode = mode + 14
        else:
            intra_mode = mode
        transpose = (intra_mode >= D.NUM_LUMA_MODE + 14) or (
            intra_mode < D.NUM_LUMA_MODE and intra_mode > 34
        )
        sb_size = 8 if whge3 else 4
        tu4x4 = w == 4 and h == 4
        tu8x8 = w == 8 and h == 8
        zero_out = 8 if (tu4x4 or tu8x8) else 16
        mode_group = int(rom.lfnst_lut()[intra_mode])
        mat = rom.lfnst_matrix(mode_group, lfnst_idx - 1, sb_size).astype(np.int64)
        return scan, mat, transpose, sb_size, zero_out

    @staticmethod
    def _lfnst_layout(transpose: bool, sb_size: int):
        """(y, x) spatial position of each entry of the LFNST sample vector
        (the layout xInvLfnst scatters to / xFwdLfnst gathers from)."""
        pos = []
        if transpose:
            if sb_size == 4:
                for x in range(4):
                    for y in range(4):
                        pos.append((y, x))
            else:
                for x in range(4):
                    for y in range(8):
                        pos.append((y, x))
                for x in range(4, 8):
                    for y in range(4):
                        pos.append((y, x))
        else:
            for y in range(sb_size):
                stride = sb_size if y < 4 else 4
                for x in range(stride):
                    pos.append((y, x))
        return pos

    def inv_lfnst(self, tu: TU, comp: int, coeffs: np.ndarray) -> np.ndarray:
        """TrQuant::xInvLfnst (TrQuant.cpp:270) — low-frequency non-separable
        secondary transform inverse on the top-left 4x4/8x8 region."""
        cu = tu.cu
        if not (cu.lfnst_idx and tu.mts_idx[comp] != D.MTS_SKIP and (
            True if cu.is_sep_tree else comp == 0
        )):
            return coeffs
        scan, mat, transpose, sb_size, zero_out = self._lfnst_setup(
            tu, comp, cu.lfnst_idx)
        flat = coeffs.ravel().astype(np.int64)
        src = np.array([flat[int(scan[i][0])] for i in range(16)], dtype=np.int64)
        # invLfnstNxN: out[j] = clip((sum_i src[i] * mat[i][j] + 64) >> 7)
        out_v = np.clip(
            (src[:zero_out] @ mat[:zero_out, :] + 64) >> 7, -32768, 32767
        )
        result = coeffs.astype(np.int64).copy()
        for i, (y, x) in enumerate(self._lfnst_layout(transpose, sb_size)):
            result[y, x] = out_v[i]
        return result.astype(np.int32)

    def fwd_lfnst(self, tu: TU, comp: int, coeffs: np.ndarray,
                  lfnst_idx: int) -> np.ndarray:
        """Encoder forward LFNST (TrQuant::xFwdLfnst, TrQuant.cpp:436):
        gathers the top-left primary coefficients in the inverse's scatter
        layout, projects onto the 16 LFNST basis rows, places the first
        `zero_out` outputs at the head of the coding scan, zeroing the rest
        of the block (the normative LFNST zero-out)."""
        scan, mat, transpose, sb_size, zero_out = self._lfnst_setup(
            tu, comp, lfnst_idx)
        c64 = coeffs.astype(np.int64)
        src = np.array(
            [c64[y, x] for (y, x) in self._lfnst_layout(transpose, sb_size)],
            dtype=np.int64,
        )
        fwd = (mat @ src + 64) >> 7
        out = np.zeros_like(coeffs, dtype=np.int64).ravel()
        for i in range(zero_out):
            out[int(scan[i][0])] = fwd[i]
        return np.clip(out, -32768, 32767).astype(np.int32).reshape(coeffs.shape)

    def _colocated_luma(self, cu: CU):
        b = cu.blocks[1]
        fmt = self.cs.chroma_format
        if cu.is_sep_tree:
            lx = (b.x + (b.w >> 1)) << fmt.scale_x
            ly = (b.y + (b.h >> 1)) << fmt.scale_y
        else:
            lx = b.x << fmt.scale_x
            ly = b.y << fmt.scale_y
        return self.cs.get_cu(lx, ly, 0)
