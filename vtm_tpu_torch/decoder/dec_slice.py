"""Slice-data decoding: substream extraction + CTU loop.

Behavioral equivalent of DecoderLib/DecSlice.cpp decompressSlice:73 —
substream split at entry points (tiles / WPP rows), CABAC init/reset rules,
WPP top-row context sync, per-CTU parse + reconstruct, terminating bits.
The CU reconstructor runs on the decoder's torch device: its finish_slice
runs the slice's MC, DMVR and BDOF through the port's kernels.  Under
torch.profiler each CTU's parse and MV derivation add to the timers `parse`
and `mv` (trace.py).
"""

from __future__ import annotations

import numpy as np

from vtm_tpu_torch import trace
from vtm_tpu_torch.common.types import SliceType
from vtm_tpu_torch.decoder import cs as D
from vtm_tpu_torch.decoder.cabac import CabacDecoder, ContextModels, make_cabac_decoder
from vtm_tpu_torch.decoder.cabac_reader import SaoParams, SyntaxReader
from vtm_tpu_torch.decoder.cs import Rect
from vtm_tpu_torch.decoder.dec_cu import CuReconstructor


def _ctx_init_id(sh) -> int:
    t = int(sh.slice_type)
    if sh.cabac_init_flag and sh.slice_type != SliceType.I:
        t = int(SliceType.P) if sh.slice_type == SliceType.B else int(SliceType.B)
    return t


def begin_slice(dec, sps, pps, ph, sh) -> None:
    """The picture's decode state on its first slice, the slice's state (its
    parameter sets, LMCS, scaling lists, CTU map) and the motion field;
    dec: declib.Decoder."""
    pic = dec.cur_pic
    # per-picture decode state on first slice
    if not hasattr(pic, "dcs"):
        n_ctu = pps.pic_width_in_ctu(sps.ctu_size) * pps.pic_height_in_ctu(sps.ctu_size)
        slice_idx_of_ctu = np.full(n_ctu, -1, dtype=np.int32)
        pic.dcs = D.DecCodingStructure(sps, pps, ph, sh, slice_idx_of_ctu)
        pic.recon = CuReconstructor(pic.dcs, pic.planes, dec.device)
        pic.sao_params = [SaoParams() for _ in range(n_ctu)]
        pic.alf_ctb_flag = [np.zeros(n_ctu, dtype=np.uint8) for _ in range(3)]
        pic.alf_ctb_alt = [None, np.zeros(n_ctu, dtype=np.uint8), np.zeros(n_ctu, dtype=np.uint8)]
        pic.alf_ctb_filter_index = np.zeros(n_ctu, dtype=np.int16)
        pic.ccalf_control = [np.zeros(n_ctu, dtype=np.uint8), np.zeros(n_ctu, dtype=np.uint8)]
        pic.slice_count = 0
    dcs = pic.dcs
    dcs.sh = sh
    dcs.ph = ph
    # snapshot the parameter-set state at slice activation: later APS NALs
    # (for following pictures) must not affect this picture's filters
    dcs.aps_map = dict(dec.psm.aps)
    dcs.__dict__.setdefault("_slice_headers", []).append(sh)
    if sh.lmcs_enabled:
        from vtm_tpu_torch.ops.lmcs import LmcsModel

        aps = dec.psm.aps[(1, ph.lmcs_aps_id)]
        cache = dec.__dict__.setdefault("_lmcs_cache", {})
        key = id(aps)
        if key not in cache:
            cache[key] = LmcsModel(aps, sps.bit_depth)
        dcs.lmcs_model = cache[key]
        pic.lmcs_model = cache[key]
    else:
        dcs.lmcs_model = None
    # explicit scaling lists (PH -> scaling-list APS activation)
    if getattr(ph, "explicit_scaling_list_enabled", False):
        dcs.scaling_list = dec.psm.aps[(2, ph.scaling_list_aps_id)].scaling_list
    else:
        dcs.scaling_list = None
    dcs.cur_slice_idx = pic.slice_count
    sh.independent_slice_idx = pic.slice_count
    dcs.cur_ind_slice_idx = pic.slice_count
    pic.slice_count += 1
    for addr in sh.ctu_addrs:
        dcs.slice_idx_of_ctu[addr] = dcs.cur_slice_idx
    # motion field (shared per picture; slices append)
    from vtm_tpu_torch.decoder import motion as M

    if not hasattr(dcs, "mf_inter"):
        M.init_motion_field(dcs)


def decompress_slice(dec, sps, pps, ph, sh, r) -> None:
    """The CTU loop of a slice that begin_slice has set up; dec:
    declib.Decoder; r: BitReader positioned at slice data start."""
    pic = dec.cur_pic
    dcs = pic.dcs
    # remaining bytes of the RBSP = slice data (reader is byte-aligned)
    data = r.data[r.pos >> 3 :]
    # split into substreams using entry point offsets
    substreams = []
    if sh.entry_point_offsets:
        pos = 0
        for size in sh.entry_point_offsets:
            substreams.append(data[pos : pos + size])
            pos += size
        substreams.append(data[pos:])
    else:
        substreams = [data]

    dcs.prev_plt.reset()  # DecSlice.cpp:97
    bit_stats = getattr(dec, "bit_stats", None)
    ctx = ContextModels()
    cab = make_cabac_decoder(substreams[0], ctx, bit_stats)
    ctx.init(sh.qp, _ctx_init_id(sh))
    cab.start()
    reader = SyntaxReader(dcs, cab)
    qps = [sh.qp, sh.qp]
    wpp = sps.entropy_coding_sync
    w_ctu = dcs.pic_w_ctu
    wpp_ctx_state: ContextModels | None = dec.__dict__.setdefault("_wpp_ctx", None)
    substream_idx = 0
    prev_cus = len(dcs.cus)
    for ctu_idx, ctu_addr in enumerate(sh.ctu_addrs):
        cx = ctu_addr % w_ctu
        cy = ctu_addr // w_ctu
        tile_col = pps.ctu_to_tile_col[cx]
        tile_row = pps.ctu_to_tile_row[cy]
        tile_x = pps.tile_col_bd[tile_col]
        tile_y = pps.tile_row_bd[tile_row]
        pos = Rect(cx * sps.ctu_size, cy * sps.ctu_size, sps.ctu_size, sps.ctu_size)
        new_substream = False
        if cx == tile_x and cy == tile_y:
            if ctu_idx != 0:
                new_substream = True
                ctx = ContextModels()
                ctx.init(sh.qp, _ctx_init_id(sh))
                dcs.prev_plt.reset()  # DecSlice.cpp:189
            qps = [sh.qp, sh.qp]
        elif cx == tile_x and wpp:
            if ctu_idx != 0:
                new_substream = True
                ctx = ContextModels()
                ctx.init(sh.qp, _ctx_init_id(sh))
                dcs.prev_plt.reset()  # DecSlice.cpp:199
            if dcs.get_cu_restricted(pos.x, pos.y - 1, pos.x, pos.y, 0) is not None:
                if dec._wpp_ctx is not None:
                    ctx = dec._wpp_ctx.copy()
                if getattr(dec, "_wpp_plt", None) is not None:
                    dcs.prev_plt.set_from(dec._wpp_plt)  # DecSlice.cpp:205
            qps = [sh.qp, sh.qp]
        if new_substream:
            substream_idx += 1
            cab = make_cabac_decoder(substreams[substream_idx], ctx, bit_stats)
            cab.start()
            reader = SyntaxReader(dcs, cab)
        else:
            cab.ctx = ctx
            reader.d = cab
        # HMVP LUT reset at the start of each CTU row within a tile
        # (DecSlice.cpp:216-221)
        if (sh.slice_type != SliceType.I or sps.ibc) and cx == tile_x:
            dcs.motion_lut.clear()
            dcs.motion_lut_ibc.clear()
            dcs.reset_ibc_buffer = True
        with trace.timer("parse"):
            reader.coding_tree_unit(pos, qps, ctu_addr, pic)
        # derive MVs for the CUs parsed for this CTU (order-exact HMVP);
        # sample reconstruction is deferred and batched at end of slice
        new_cus = dcs.cus[prev_cus:]
        prev_cus = len(dcs.cus)
        with trace.timer("mv"):
            pic.recon.derive_cus(new_cus)
        if cx == tile_x and wpp:
            dec._wpp_ctx = cab.ctx.copy()
            dec._wpp_plt = dcs.prev_plt.copy()  # DecSlice.cpp:239
        if ctu_idx == len(sh.ctu_addrs) - 1:
            term = cab.decode_bin_trm()
            assert term == 1, "missing terminating bit at end of slice"
        elif wpp or True:
            # terminating bit at each tile/wpp substream end
            next_addr = sh.ctu_addrs[ctu_idx + 1]
            nx, ny = next_addr % w_ctu, next_addr // w_ctu
            end_of_tile = (
                pps.ctu_to_tile_col[nx] != tile_col or pps.ctu_to_tile_row[ny] != tile_row
            )
            end_of_row = wpp and ny != cy
            if end_of_tile or end_of_row:
                term = cab.decode_bin_trm()
                assert term == 1, "missing terminating bit at tile/row end"
    # batched sample reconstruction for the whole slice
    pic.recon.finish_slice()
