"""SAO — exact integer reference implementation.

Behavioral contract from CommonLib/SampleAdaptiveOffset.cpp: merge-list
resolution + offset dequantization (getMergeList:173,
reconstructBlkSAOParam:230, invertQuantOffsets), per-CTU application with
boundary availability (offsetCTU:549, offsetBlock:293,
deriveLoopFilterBoundaryAvailibility:668).  The encoder's picture SAO
applies the maps of `build_sao_maps` through the port's `sao_apply`
(csrc/sao.cu on a GPU, the plain version on the CPU).
"""

from __future__ import annotations

import numpy as np

from vtm_tpu_torch.ops import sao_kernel as SK
from vtm_tpu_torch.ops import to_host
from vtm_tpu_torch.ops.filter_chain import to_device

SAO_MODE_OFF, SAO_MODE_NEW, SAO_MODE_MERGE = 0, 1, 2
SAO_MERGE_LEFT, SAO_MERGE_ABOVE = 0, 1
SAO_TYPE_EO_0, SAO_TYPE_EO_90, SAO_TYPE_EO_135, SAO_TYPE_EO_45, SAO_TYPE_BO = 0, 1, 2, 3, 4


def _sgn(x: int) -> int:
    return (x > 0) - (x < 0)


def sao_picture(dcs, pic, device) -> None:
    """SAOProcess over the picture using pic.sao_params (post-parse), on
    `device`, written back in place into `pic.planes`."""
    for comp, args in enumerate(build_sao_maps(dcs, pic)):
        if args is None:
            continue
        plane = pic.planes[comp]
        out = SK.sao_apply(to_device(plane, device),
                           *(to_device(a, device) for a in args),
                           bit_depth=dcs.sps.bit_depth)
        plane[:] = to_host(out).numpy().astype(plane.dtype)


def build_sao_maps(dcs, pic) -> list:
    """Resolve merges/offsets and build the per-pixel type/offset/validity
    maps per component (sample-independent); None = component inactive."""
    sps = dcs.sps
    n_comp = dcs.chroma_format.num_components
    w_ctu, h_ctu = dcs.pic_w_ctu, dcs.pic_h_ctu
    # resolve merges + dequant offsets, CTU raster order
    resolved = [None] * (w_ctu * h_ctu)
    shift = [max(0, sps.bit_depth - 10)] * 3
    for addr in range(w_ctu * h_ctu):
        cx, cy = addr % w_ctu, addr // w_ctu
        p = pic.sao_params[addr]
        import copy

        rp = copy.deepcopy(p)
        cu = dcs.get_cu(cx * sps.ctu_size, cy * sps.ctu_size, 0)
        for comp in range(n_comp):
            if rp.mode[comp] == SAO_MODE_OFF:
                continue
            if rp.mode[comp] == SAO_MODE_NEW:
                sc = 1 << shift[comp]
                if rp.type_idc[comp] == 4:  # BO
                    new_off = [0] * 32
                    for i in range(4):
                        k = (rp.type_aux[comp] + i) % 32
                        new_off[k] = rp.offsets[comp][k] * sc
                    rp.offsets[comp] = new_off
                else:
                    rp.offsets[comp] = [v * sc for v in rp.offsets[comp][:5]] + [0] * 27
            else:  # merge
                merge_type = rp.type_idc[comp]
                if merge_type == SAO_MERGE_LEFT:
                    src = resolved[addr - 1]
                else:
                    src = resolved[addr - w_ctu]
                rp.mode[comp] = src.mode[comp]
                rp.type_idc[comp] = src.type_idc[comp]
                rp.type_aux[comp] = src.type_aux[comp]
                rp.offsets[comp] = list(src.offsets[comp])
        resolved[addr] = rp
    # per-pixel type/offset/validity maps per CTU (sample-independent)
    fmt = dcs.chroma_format
    n_ctu = w_ctu * h_ctu
    avail_cache = {}
    result = [None, None, None]
    for comp in range(n_comp):
        if all(resolved[a].mode[comp] == SAO_MODE_OFF for a in range(n_ctu)):
            continue
        sx = fmt.scale_x if comp else 0
        sy = fmt.scale_y if comp else 0
        H, W = pic.planes[comp].shape
        type_map = np.zeros((H, W), dtype=np.int32)
        ctu_map = np.zeros((H, W), dtype=np.int32)
        valid = np.zeros((H, W), dtype=bool)
        offsets = np.zeros((n_ctu, 32), dtype=np.int32)
        for addr in range(n_ctu):
            rp = resolved[addr]
            if rp.mode[comp] == SAO_MODE_OFF:
                continue
            cx, cy = addr % w_ctu, addr // w_ctu
            x0, y0 = cx * sps.ctu_size, cy * sps.ctu_size
            if addr not in avail_cache:
                avail_cache[addr] = _boundary_avail(dcs, x0, y0)
            bx0, by0 = x0 >> sx, y0 >> sy
            bw = min(sps.ctu_size >> sx, W - bx0)
            bh = min(sps.ctu_size >> sy, H - by0)
            t = rp.type_idc[comp]
            offsets[addr] = rp.offsets[comp][:32]
            type_map[by0 : by0 + bh, bx0 : bx0 + bw] = t
            ctu_map[by0 : by0 + bh, bx0 : bx0 + bw] = addr
            _set_valid(valid, bx0, by0, bw, bh, t, avail_cache[addr])
        result[comp] = (type_map, ctu_map, offsets, valid)
    return result


def _set_valid(valid, x0, y0, w, h, type_idx, avail):
    """Per-pixel application ranges of _offset_block, as mask writes."""
    left, right, above, below, al, ar, bl, br = avail
    sx = 0 if left else 1
    ex = w if right else w - 1
    if type_idx == SAO_TYPE_EO_0:
        valid[y0 : y0 + h, x0 + sx : x0 + ex] = True
    elif type_idx == SAO_TYPE_EO_90:
        sy = 0 if above else 1
        ey = h if below else h - 1
        valid[y0 + sy : y0 + ey, x0 : x0 + w] = True
    elif type_idx == SAO_TYPE_EO_135:
        fs = 0 if al else 1
        fe = ex if above else 1
        valid[y0, x0 + fs : x0 + fe] = True
        valid[y0 + 1 : y0 + h - 1, x0 + sx : x0 + ex] = True
        ls = sx if below else w - 1
        le = w if br else w - 1
        valid[y0 + h - 1, x0 + ls : x0 + le] = True
    elif type_idx == SAO_TYPE_EO_45:
        fs = sx if above else w - 1
        fe = w if ar else w - 1
        valid[y0, x0 + fs : x0 + fe] = True
        valid[y0 + 1 : y0 + h - 1, x0 + sx : x0 + ex] = True
        ls = 0 if bl else 1
        le = ex if below else 1
        valid[y0 + h - 1, x0 + ls : x0 + le] = True
    else:  # BO
        valid[y0 : y0 + h, x0 : x0 + w] = True


def _boundary_avail(dcs, x0, y0):
    """deriveLoopFilterBoundaryAvailibility — (l, r, a, b, al, ar, bl, br)."""
    ctu = dcs.sps.ctu_size
    cur = dcs.get_cu(x0, y0, 0)
    pps = dcs.pps

    def ok(x, y):
        c = dcs.get_cu(x, y, 0)
        if c is None:
            return False
        if not pps.loop_filter_across_slices and c.slice_idx != cur.slice_idx:
            return False
        if not pps.loop_filter_across_tiles and c.tile_idx != cur.tile_idx:
            return False
        return True

    return (
        ok(x0 - ctu, y0), ok(x0 + ctu, y0), ok(x0, y0 - ctu), ok(x0, y0 + ctu),
        ok(x0 - ctu, y0 - ctu), ok(x0 + ctu, y0 - ctu),
        ok(x0 - ctu, y0 + ctu), ok(x0 + ctu, y0 + ctu),
    )


def _offset_block(src, res, x0, y0, w, h, type_idx, offsets, bit_depth, maxv, avail):
    left, right, above, below, al, ar, bl, br = avail

    def s(y, x):
        return int(src[y0 + y, x0 + x])

    def put(y, x, v):
        res[y0 + y, x0 + x] = max(0, min(maxv, v))

    if type_idx == SAO_TYPE_EO_0:
        off = offsets
        start_x = 0 if left else 1
        end_x = w if right else w - 1
        for y in range(h):
            sign_left = _sgn(s(y, start_x) - s(y, start_x - 1))
            for x in range(start_x, end_x):
                sign_right = _sgn(s(y, x) - s(y, x + 1))
                edge = sign_right + sign_left
                sign_left = -sign_right
                put(y, x, s(y, x) + off[edge + 2])
    elif type_idx == SAO_TYPE_EO_90:
        off = offsets
        start_y = 0 if above else 1
        end_y = h if below else h - 1
        sign_up = [
            _sgn(s(start_y, x) - s(start_y - 1, x)) for x in range(w)
        ]
        for y in range(start_y, end_y):
            for x in range(w):
                sign_down = _sgn(s(y, x) - s(y + 1, x))
                edge = sign_down + sign_up[x]
                sign_up[x] = -sign_down
                put(y, x, s(y, x) + off[edge + 2])
    elif type_idx == SAO_TYPE_EO_135:
        off = offsets
        start_x = 0 if left else 1
        end_x = w if right else w - 1
        sign_up = [0] * (w + 1)
        for x in range(start_x, end_x + 1):
            sign_up[x] = _sgn(s(1, x) - s(0, x - 1))
        # first line
        fs = 0 if al else 1
        fe = end_x if above else 1
        for x in range(fs, fe):
            edge = _sgn(s(0, x) - s(-1, x - 1)) - sign_up[x + 1]
            put(0, x, s(0, x) + off[edge + 2])
        # middle lines
        sign_down_line = [0] * (w + 1)
        for y in range(1, h - 1):
            for x in range(start_x, end_x):
                sign_down = _sgn(s(y, x) - s(y + 1, x + 1))
                edge = sign_down + sign_up[x]
                put(y, x, s(y, x) + off[edge + 2])
                sign_down_line[x + 1] = -sign_down
            sign_down_line[start_x] = _sgn(s(y + 1, start_x) - s(y, start_x - 1))
            sign_up, sign_down_line = sign_down_line, sign_up
        # last line
        ls = start_x if below else w - 1
        le = w if br else w - 1
        for x in range(ls, le):
            edge = _sgn(s(h - 1, x) - s(h, x + 1)) + sign_up[x]
            put(h - 1, x, s(h - 1, x) + off[edge + 2])
    elif type_idx == SAO_TYPE_EO_45:
        off = offsets
        start_x = 0 if left else 1
        end_x = w if right else w - 1
        sign_up = [0] * (w + 2)  # indexed x in [-1, w]; use +1 shift

        def su_get(x):
            return sign_up[x + 1]

        def su_set(x, v):
            sign_up[x + 1] = v

        for x in range(start_x - 1, end_x):
            su_set(x, _sgn(s(1, x) - s(0, x + 1)))
        fs = start_x if above else w - 1
        fe = w if ar else w - 1
        for x in range(fs, fe):
            edge = _sgn(s(0, x) - s(-1, x + 1)) - su_get(x - 1)
            put(0, x, s(0, x) + off[edge + 2])
        for y in range(1, h - 1):
            for x in range(start_x, end_x):
                sign_down = _sgn(s(y, x) - s(y + 1, x - 1))
                edge = sign_down + su_get(x)
                put(y, x, s(y, x) + off[edge + 2])
                su_set(x - 1, -sign_down)
            su_set(end_x - 1, _sgn(s(y + 1, end_x - 1) - s(y, end_x)))
        ls = 0 if bl else 1
        le = end_x if below else 1
        for x in range(ls, le):
            edge = _sgn(s(h - 1, x) - s(h, x - 1)) + su_get(x)
            put(h - 1, x, s(h - 1, x) + off[edge + 2])
    else:  # BO
        shift_bits = bit_depth - 5
        block = src[y0 : y0 + h, x0 : x0 + w].astype(np.int64)
        off_arr = np.asarray(offsets[:32], dtype=np.int64)
        res[y0 : y0 + h, x0 : x0 + w] = np.clip(
            block + off_arr[block >> shift_bits], 0, maxv
        ).astype(res.dtype)
