"""DMVR bilateral MV refinement + BDOF optical-flow refinement.

Behavioral equivalent of InterPrediction.cpp xProcessDMVR:1997,
xPrefetch:1664, xPad:1710, xinitMC:1949, xBIPMVRefine:1820,
xDMVRCost:1919, xSubPelErrorSrfc:1766, xFinalPaddedMCForDMVR:1845,
applyBiOptFlow:1233 and the Buffer.cpp BDOF cores (gradFilterCore:130,
calcBIOSumsCore:173, addBIOAvgCore:88).
"""

from __future__ import annotations

import numpy as np

from vtm_tpu_torch.decoder import motion as M
from vtm_tpu_torch.ops import mc as MC
from vtm_tpu_torch.ops import refine_kernel as RK
from vtm_tpu_torch.ops import to_host, upload
from vtm_tpu_torch.ops.mc_kernel import McBatch

DMVR_ITER = 2  # DMVR_NUM_ITERATION
DMVR_SUBCU = 16
BIO_EXT = 1
_SEARCH_OFFSETS = [(dx, dy) for dy in range(-2, 3) for dx in range(-2, 3)]


# ---------------------------------------------------------------------------
# helpers

def _gather(plane, x0, y0, w, h):
    ph, pw = plane.shape
    if 0 <= x0 and 0 <= y0 and x0 + w <= pw and y0 + h <= ph:
        return plane[y0 : y0 + h, x0 : x0 + w].astype(np.int64)
    ys = np.clip(np.arange(y0, y0 + h), 0, ph - 1)
    xs = np.clip(np.arange(x0, x0 + w), 0, pw - 1)
    return plane[np.ix_(ys, xs)].astype(np.int64)


def _pad2(a, pad):
    return np.pad(a, pad, mode="edge")


def _floor_log2(v: int) -> int:
    return v.bit_length() - 1


def _div_for_maxq7(n: int, d: int) -> int:
    sign = 0
    if n < 0:
        sign = 1
        n = -n
    q = 0
    d = d << 3
    if n >= d:
        n -= d
        q += 1
    q <<= 1
    d >>= 1
    if n >= d:
        n -= d
        q += 1
    q <<= 1
    if n >= (d >> 1):
        q += 1
    return -q if sign else q


def _subpel_error_srfc(sad):
    """xSubPelErrorSrfc; sad = [center, left, top, right, bottom]."""
    delta = [0, 0]
    num = (sad[1] - sad[3]) << 4
    den = sad[1] + sad[3] - (sad[0] << 1)
    if den != 0:
        if sad[1] != sad[0] and sad[3] != sad[0]:
            delta[0] = _div_for_maxq7(num, den)
        else:
            delta[0] = -8 if sad[1] == sad[0] else 8
    num = (sad[2] - sad[4]) << 4
    den = sad[2] + sad[4] - (sad[0] << 1)
    if den != 0:
        if sad[2] != sad[0] and sad[4] != sad[0]:
            delta[1] = _div_for_maxq7(num, den)
        else:
            delta[1] = -8 if sad[2] == sad[0] else 8
    return delta


def _bilinear_grid(pre, frac_x, frac_y, w, h, bd):
    """DMVR search-grid generation: 2-tap bilinear at 10-bit precision
    (xinitMC → xPredInterBlk with bilinearMC; InterpolationFilter biMCForDMVR
    paths).  `pre` is the padded prefetch buffer; output (h, w) from its
    (1, 1) origin."""
    coeffs = MC._BILINEAR  # (16, 2), 4-bit precision
    src = pre[1 : 1 + h + 1, 1 : 1 + w + 1]  # support for 2-tap both dirs
    prec_bilinear = 10
    if frac_x == 0 and frac_y == 0:
        return (src[:h, :w] << (prec_bilinear - bd)).astype(np.int64)
    if frac_y == 0:
        c = coeffs[frac_x]
        shift = 4 - (prec_bilinear - bd)
        off = 1 << (shift - 1)
        return (int(c[0]) * src[:h, :w] + int(c[1]) * src[:h, 1 : w + 1] + off) >> shift
    if frac_x == 0:
        c = coeffs[frac_y]
        shift = 4 - (prec_bilinear - bd)
        off = 1 << (shift - 1)
        return (int(c[0]) * src[:h, :w] + int(c[1]) * src[1 : h + 1, :w] + off) >> shift
    ch = coeffs[frac_x]
    shift1 = 4 - (prec_bilinear - bd)
    off1 = 1 << (shift1 - 1)
    tmp = (int(ch[0]) * src[:, :w] + int(ch[1]) * src[:, 1 : w + 1] + off1) >> shift1
    cv = coeffs[frac_y]
    return (int(cv[0]) * tmp[:h, :] + int(cv[1]) * tmp[1 : h + 1, :] + 8) >> 4


def _sad_even_rows(a, b):
    return int(np.abs(a[::2] - b[::2]).sum())


# ---------------------------------------------------------------------------
def _mc_ext_bio(plane, x0, y0, w, h, frac_x, frac_y, bd, use_alt_hpel):
    """Luma MC for BDOF: returns (h+2, w+2) — centre w×h is the 14-bit MC
    result, the 1-sample ring is nearest-integer reference samples shifted
    to the intermediate domain (xPredInterBlk bioApplied tail)."""
    center = MC.mc_block(plane, x0, y0, w, h, frac_x, frac_y, True, bd,
                         rnd_res=False, use_alt_hpel=use_alt_hpel)
    shift = max(2, MC.IF_INTERNAL_PREC - bd)
    x_off = 1 if frac_x < 8 else 0
    y_off = 1 if frac_y < 8 else 0
    ring_src = _gather(plane, x0 - x_off, y0 - y_off, w + 2, h + 2)
    ring = (ring_src << shift) - MC.IF_INTERNAL_OFFS
    out = np.empty((h + 2, w + 2), dtype=np.int64)
    out[:] = ring
    out[1 : h + 1, 1 : w + 1] = center
    return out


def bdof_blend(p0e, p1e, w, h, bd):
    """applyBiOptFlow core on extended predictions (h+2, w+2)."""
    shift1 = 6
    # gradients over the extended grid (inner w×h from the int-ring source)
    g = []
    for pe in (p0e, p1e):
        gx = np.zeros((h + 2, w + 2), dtype=np.int64)
        gy = np.zeros((h + 2, w + 2), dtype=np.int64)
        gx[1 : h + 1, 1 : w + 1] = (pe[1 : h + 1, 2 : w + 2] >> shift1) - (
            pe[1 : h + 1, 0:w] >> shift1
        )
        gy[1 : h + 1, 1 : w + 1] = (pe[2 : h + 2, 1 : w + 1] >> shift1) - (
            pe[0:h, 1 : w + 1] >> shift1
        )
        # pad ring by replication (gradFilterCore PAD)
        gx[1 : h + 1, 0] = gx[1 : h + 1, 1]
        gx[1 : h + 1, w + 1] = gx[1 : h + 1, w]
        gy[1 : h + 1, 0] = gy[1 : h + 1, 1]
        gy[1 : h + 1, w + 1] = gy[1 : h + 1, w]
        gx[0] = gx[1]
        gx[h + 1] = gx[h]
        gy[0] = gy[1]
        gy[h + 1] = gy[h]
        g.append((gx, gy))
    (gx0, gy0), (gx1, gy1) = g
    # re-pad the prediction ring from the MC block edges (applyBiOptFlow)
    for pe in (p0e, p1e):
        pe[1 : h + 1, 0] = pe[1 : h + 1, 1]
        pe[1 : h + 1, w + 1] = pe[1 : h + 1, w]
        pe[0, :] = pe[1, :]
        pe[h + 1, :] = pe[h, :]

    shift_num = MC.IF_INTERNAL_PREC + 1 - bd
    offset = (1 << (shift_num - 1)) + 2 * MC.IF_INTERNAL_OFFS
    limit = 15
    maxv = (1 << bd) - 1
    # vectorized over all 4x4 subblocks: 6x6 window sums at stride 4
    from numpy.lib.stride_tricks import sliding_window_view as swv

    tmp_gx = (gx0 + gx1) >> 1
    tmp_gy = (gy0 + gy1) >> 1
    tmp_di = (p1e >> 4) - (p0e >> 4)
    sgx = np.sign(tmp_gx)
    sgy = np.sign(tmp_gy)

    def wsum(a):
        return swv(a, (6, 6))[::4, ::4].sum(axis=(2, 3))

    sum_abs_gx = wsum(np.abs(tmp_gx))
    sum_abs_gy = wsum(np.abs(tmp_gy))
    sum_dix = wsum(sgx * tmp_di)
    sum_diy = wsum(sgy * tmp_di)
    sum_sign = wsum(sgy * tmp_gx)
    # floor_log2 via frexp (values are exact in float64 range)
    lg_gx = np.frexp(np.maximum(sum_abs_gx, 1).astype(np.float64))[1] - 1
    lg_gy = np.frexp(np.maximum(sum_abs_gy, 1).astype(np.float64))[1] - 1
    tmpx = np.where(sum_abs_gx == 0, 0, (sum_dix << 2) >> lg_gx)
    tmpx = np.clip(tmpx, -limit, limit)
    mains = sum_sign >> 12
    secs = sum_sign & 4095
    tmp_data = (((tmpx * mains) << 12) + tmpx * secs) >> 1
    tmpy = np.where(sum_abs_gy == 0, 0, ((sum_diy << 2) - tmp_data) >> lg_gy)
    tmpy = np.clip(tmpy, -limit, limit)
    # blend inner 4x4s (extended coords +1): broadcast per-subblock tmpx/y
    tx = np.repeat(np.repeat(tmpx, 4, axis=0), 4, axis=1)
    ty = np.repeat(np.repeat(tmpy, 4, axis=0), 4, axis=1)
    inner = slice(1, h + 1), slice(1, w + 1)
    b = tx * (gx0[inner] - gx1[inner]) + ty * (gy0[inner] - gy1[inner])
    val = (p0e[inner] + p1e[inner] + b + offset) >> shift_num
    return np.clip(val, 0, maxv)


MAX_BDOF_REGION = 16


def bdof_motion_compensation(recon, dcs, cu):
    """Standalone BDOF bi-prediction; PUs larger than 16x16 are processed
    per 16x16 subblock (InterPrediction::xSubPuBio:352), each with its own
    MV clipping and integer-sample ring."""
    sh = dcs.sh
    bd = recon.bit_depth
    fmt = dcs.chroma_format
    b = cu.blocks[0]
    use_alt_hpel = cu.imv == M.IMV_HPEL
    dx = min(MAX_BDOF_REGION, b.w)
    dy = min(MAX_BDOF_REGION, b.h)
    preds = [np.zeros((b.h >> (fmt.scale_y if c else 0),
                       b.w >> (fmt.scale_x if c else 0)), dtype=np.int64)
             for c in range(fmt.num_components)]
    for y in range(b.y, b.y + b.h, dy):
        for x in range(b.x, b.x + b.w, dx):
            exts = []
            chroma = [[], []]
            for lst in range(2):
                ref_pic = sh.ref_pics[lst][cu.ref_idx[lst]]
                mv = M.clip_mv_in_pic(cu.mv[lst], x, y, dcs)
                exts.append(
                    _mc_ext_bio(ref_pic.planes[0], x + (mv[0] >> 4),
                                y + (mv[1] >> 4), dx, dy, mv[0] & 15,
                                mv[1] & 15, bd, use_alt_hpel)
                )
                for comp in range(1, fmt.num_components):
                    scx, scy = fmt.scale_x, fmt.scale_y
                    fx = mv[0] & ((1 << (4 + scx)) - 1)
                    fy = mv[1] & ((1 << (4 + scy)) - 1)
                    chroma[lst].append(
                        MC.mc_block(
                            ref_pic.planes[comp],
                            (x >> scx) + (mv[0] >> (4 + scx)),
                            (y >> scy) + (mv[1] >> (4 + scy)),
                            dx >> scx, dy >> scy, fx, fy, False, bd,
                            rnd_res=False, scale_x=scx, scale_y=scy,
                        )
                    )
            ly, lx = y - b.y, x - b.x
            preds[0][ly : ly + dy, lx : lx + dx] = bdof_blend(
                exts[0], exts[1], dx, dy, bd
            )
            for ci in range(fmt.num_components - 1):
                scx, scy = fmt.scale_x, fmt.scale_y
                preds[1 + ci][ly >> scy : (ly + dy) >> scy,
                              lx >> scx : (lx + dx) >> scx] = MC.bi_average(
                    chroma[0][ci], chroma[1][ci], bd
                )
    return preds


# ---------------------------------------------------------------------------
# batched (device) paths — slice-level orchestration over the kernels in
# ops/refine_kernel.py and ops/mc_kernel.py on the decoder's torch device;
# bit-exact twins of the scalar entry points below.  The prefetch windows
# and the BDOF rings are read from the reference pictures' host planes
# (`Picture.planes`): on a GPU that fetches each reference picture once.

def _padded_plane_i32(pic, comp: int, pad: int) -> np.ndarray:
    """Edge-replicated int32 copy of a (final) reference plane, cached on the
    Picture — makes every DMVR prefetch window an interior read so windows
    batch as one fancy-index per plane."""
    cache = getattr(pic, "_dmvr_pad_cache", None)
    if cache is None:
        cache = pic._dmvr_pad_cache = {}
    plane = pic.planes[comp]
    ent = cache.get(comp)
    if ent is not None and ent[0] == pad and ent[1] == id(plane):
        return ent[2]
    arr = np.pad(plane, pad, mode="edge").astype(np.int32)
    cache[comp] = (pad, id(plane), arr)
    return arr


def _windows(padded, pad, fx, fy, wh: int, ww: int) -> np.ndarray:
    """Batched window gather: all (wh, ww) windows whose clamped reads the
    padding already materialized."""
    from numpy.lib.stride_tricks import sliding_window_view as swv

    return swv(padded, (wh, ww))[fy + pad, fx + pad]


def dmvr_batch(recon, dcs, jobs):
    """Batched xProcessDMVR over all DMVR CUs of a slice: per (dx, dy)
    group one bilateral search, one packed final FIR (both lists' luma and
    all chroma) and one BDOF blend of the sub-PUs that keep BDOF.

    jobs: list of (cu, bio_applied).  Returns {id(cu): preds}; also sets
    cu._dmvr_mvd for the motion-field write-back."""
    sh = dcs.sh
    bd = recon.bit_depth
    dev = recon.device
    fmt = dcs.chroma_format
    ncomp = fmt.num_components
    scx, scy = fmt.scale_x, fmt.scale_y
    pad_p = dcs.ctu_size + 16
    out_preds = {}

    groups: dict = {}
    for cu, bio in jobs:
        b = cu.blocks[0]
        dx = min(b.w, DMVR_SUBCU)
        dy = min(b.h, DMVR_SUBCU)
        preds = [np.zeros((b.h >> (scy if c else 0), b.w >> (scx if c else 0)),
                          dtype=np.int64) for c in range(ncomp)]
        out_preds[id(cu)] = preds
        mvd_sub = {}
        cu._dmvr_mvd = (mvd_sub, dx, dy)
        g = groups.setdefault((dx, dy), {"cu": [], "ci": [], "x": [], "y": []})
        ci = len(g["cu"])
        g["cu"].append({
            "cu": cu, "bio": bio, "preds": preds, "mvd_sub": mvd_sub,
            "pics": (sh.ref_pics[0][cu.ref_idx[0]],
                     sh.ref_pics[1][cu.ref_idx[1]]),
        })
        nsx, nsy = b.w // dx, b.h // dy
        gx, gy = np.meshgrid(np.arange(nsx), np.arange(nsy))
        g["x"].append(b.x + gx.ravel().astype(np.int64) * dx)
        g["y"].append(b.y + gy.ravel().astype(np.int64) * dy)
        g["ci"].append(np.full(nsx * nsy, ci, np.int64))

    for (dx, dy), g in groups.items():
        cus = g["cu"]
        X = np.concatenate(g["x"])
        Y = np.concatenate(g["y"])
        CI = np.concatenate(g["ci"])
        N = X.size
        mm = np.array([[c["cu"].mv[0], c["cu"].mv[1]] for c in cus],
                      dtype=np.int64)                      # (ncu, 2, 2)
        bio_cu = np.fromiter((c["bio"] for c in cus), bool, len(cus))
        mmx, mmy = mm[CI, :, 0], mm[CI, :, 1]              # (N, 2)

        # clipMvInPic bounds per subblock (Mv.cpp:56)
        hor_max = (dcs.pic_w + 8 - X - 1) << 4
        hor_min = (-dcs.ctu_size - 8 - X + 1) << 4
        ver_max = (dcs.pic_h + 8 - Y - 1) << 4
        ver_min = (-dcs.ctu_size - 8 - Y + 1) << 4

        def clipmv(mx, my):
            return (np.clip(mx, hor_min, hor_max),
                    np.clip(my, ver_min, ver_max))

        pid = [np.fromiter((id(c["pics"][lst]) for c in cus), np.int64,
                           len(cus)) for lst in range(2)]

        def plane_gather(lst, comp, ox, oy, wh, ww):
            """Batched window gather grouped by distinct reference picture."""
            buf = np.empty((N, wh, ww), np.int32)
            sub_pid = pid[lst][CI]
            for upid in np.unique(sub_pid):
                m = sub_pid == upid
                pic = next(c["pics"][lst] for c in cus
                           if id(c["pics"][lst]) == upid)
                padded = _padded_plane_i32(pic, comp, pad_p)
                buf[m] = _windows(padded, pad_p, ox[m], oy[m], wh, ww)
            return buf

        # ---- prefetch (xPrefetch forLuma) + search fracs ----
        pres, frs = [], []
        for lst in range(2):
            cmvx, cmvy = clipmv(mmx[:, lst] - 48, mmy[:, lst] - 48)
            fx = X + (cmvx >> 4)
            fy = Y + (cmvy >> 4)
            pres.append(plane_gather(lst, 0, fx, fy, dy + 7, dx + 7))
            mclx, mcly = clipmv(mmx[:, lst], mmy[:, lst])
            frs.append((mclx & 15, mcly & 15))
        pre0, pre1, *fr = upload([pres[0], pres[1], *frs[0], *frs[1]], dev)
        search = RK.dmvr_search(pre0, pre1, *fr, bd=bd, dx=dx, dy=dy)
        search = to_host(search).numpy()
        tx = search[0].astype(np.int64)
        ty = search[1].astype(np.int64)
        mcost = search[2]
        bio_sub = np.where(mcost < 2 * dx * dy, False, bio_cu[CI])
        moved = (tx != 0) | (ty != 0)

        # ---- final padded MC (xFinalPaddedMCForDMVR): both lists' luma
        # and chroma FIR arguments, run as one packed output ----
        sub_mvx = np.stack([mmx[:, 0] + tx, mmx[:, 1] - tx], axis=1)
        sub_mvy = np.stack([mmy[:, 0] + ty, mmy[:, 1] - ty], axis=1)
        ext_off = []
        lhost, chost = [], []
        w_c, h_c = dx >> scx, dy >> scy
        for lst in range(2):
            cmx, cmy = clipmv(sub_mvx[:, lst], sub_mvy[:, lst])
            frx, fry = cmx & 15, cmy & 15
            x0 = 3 + (sub_mvx[:, lst] >> 4) - (mmx[:, lst] >> 4)
            y0 = 3 + (sub_mvy[:, lst] >> 4) - (mmy[:, lst] >> 4)
            lhost.append((x0, y0, MC._LUMA[frx], MC._LUMA[fry]))
            ext_off.append((x0 - (frx < 8), y0 - (fry < 8)))

            for comp in range(1, ncomp):
                frx_c = cmx & ((1 << (4 + scx)) - 1)
                fry_c = cmy & ((1 << (4 + scy)) - 1)
                # moved blocks re-read the merge-MV prefetch window
                # (xPrefetch !forLuma) and offset inside it; unmoved blocks
                # read the reference directly at the clipped final MV
                ccmvx, ccmvy = clipmv(mmx[:, lst] - (1 << (4 + scx)),
                                      mmy[:, lst] - (1 << (4 + scy)))
                mv_ox = (X >> scx) + (ccmvx >> (4 + scx))
                mv_oy = (Y >> scy) + (ccmvy >> (4 + scy))
                di_x = (sub_mvx[:, lst] >> (4 + scx)) - (mmx[:, lst] >> (4 + scx))
                di_y = (sub_mvy[:, lst] >> (4 + scy)) - (mmy[:, lst] >> (4 + scy))
                um_ox = (X >> scx) + (cmx >> (4 + scx)) - 1
                um_oy = (Y >> scy) + (cmy >> (4 + scy)) - 1
                org_x = np.where(moved, mv_ox, um_ox)
                org_y = np.where(moved, mv_oy, um_oy)
                x0c = np.where(moved, 1 + di_x, 1)
                y0c = np.where(moved, 1 + di_y, 1)
                bufc = plane_gather(lst, comp, org_x, org_y, h_c + 3, w_c + 3)
                chost.append((bufc, x0c, y0c, MC._CHROMA[frx_c << (1 - scx)],
                              MC._CHROMA[fry_c << (1 - scy)]))
        dev_args = upload([a for args in lhost + chost for a in args], dev)
        largs = [(pre,) + tuple(dev_args[4 * i:4 * i + 4])
                 for i, pre in enumerate((pre0, pre1))]
        cargs = tuple(tuple(dev_args[8 + 5 * k:8 + 5 * k + 5])
                      for k in range(len(chost)))
        flat = to_host(RK.dmvr_final_pack(largs[0], largs[1], cargs, w=dx, h=dy,
                                          wc=w_c, hc=h_c, bd=bd)).numpy()
        lsz = N * dy * dx
        csz = N * h_c * w_c
        luma_out = [flat[i * lsz:(i + 1) * lsz].reshape(N, dy, dx)
                    for i in range(2)]
        # cargs order is list-major: [l0 comps..., l1 comps...]
        chroma_out = [[], []]  # [comp-1][lst]
        for lst in range(2):
            for ci in range(ncomp - 1):
                k = lst * (ncomp - 1) + ci
                seg = flat[2 * lsz + k * csz:2 * lsz + (k + 1) * csz]
                chroma_out[ci].append(seg.reshape(N, h_c, w_c))

        # ---- blend: BDOF (batched) or bi-average ----
        blended = np.empty((N, dy, dx), np.int64)
        nonbio = ~bio_sub
        if nonbio.any():
            blended[nonbio] = MC.bi_average(
                luma_out[0][nonbio].astype(np.int64),
                luma_out[1][nonbio].astype(np.int64), bd)
        bio_idx = np.nonzero(bio_sub)[0]
        if bio_idx.size:
            nb = bio_idx.size
            shift_b = max(2, MC.IF_INTERNAL_PREC - bd)
            exts = []
            for lst in range(2):
                ox = ext_off[lst][0][bio_idx]
                oy = ext_off[lst][1][bio_idx]
                buf = pres[lst][bio_idx]
                iy = np.clip(oy[:, None] + np.arange(dy + 2), 0, dy + 6)
                ix = np.clip(ox[:, None] + np.arange(dx + 2), 0, dx + 6)
                ring = buf[np.arange(nb)[:, None, None],
                           iy[:, :, None], ix[:, None, :]].astype(np.int32)
                ext = (ring << shift_b) - MC.IF_INTERNAL_OFFS
                ext[:, 1:dy + 1, 1:dx + 1] = luma_out[lst][bio_idx]
                exts.append(ext)
            p0e, p1e = upload(exts, dev)
            res = RK.bdof_blend_batch(p0e, p1e, bd=bd, w=dx, h=dy)
            blended[bio_idx] = to_host(res).numpy().astype(np.int64)

        chroma_blend = [MC.bi_average(chroma_out[c][0].astype(np.int64),
                                      chroma_out[c][1].astype(np.int64), bd)
                        for c in range(ncomp - 1)]

        # ---- write back ----
        for i in range(N):
            c = cus[CI[i]]
            b = c["cu"].blocks[0]
            ys0 = int(Y[i]) - b.y
            xs0 = int(X[i]) - b.x
            c["mvd_sub"][(ys0 // dy, xs0 // dx)] = (int(tx[i]), int(ty[i]))
            c["preds"][0][ys0:ys0 + dy, xs0:xs0 + dx] = blended[i]
            for comp in range(1, ncomp):
                c["preds"][comp][ys0 >> scy:(ys0 + dy) >> scy,
                                 xs0 >> scx:(xs0 + dx) >> scx] = \
                    chroma_blend[comp - 1][i]
    return out_preds


def bdof_batch(recon, dcs, cus):
    """Batched standalone BDOF bi-prediction (xSubPuBio regions): the MC of
    every region on one McBatch, then one BDOF blend per region size."""
    sh = dcs.sh
    bd = recon.bit_depth
    fmt = dcs.chroma_format
    ncomp = fmt.num_components
    out_preds = {}
    groups = {}
    batch = McBatch(bd, recon.device)
    for cu in cus:
        b = cu.blocks[0]
        use_alt_hpel = cu.imv == M.IMV_HPEL
        dx = min(MAX_BDOF_REGION, b.w)
        dy = min(MAX_BDOF_REGION, b.h)
        preds = [np.zeros((b.h >> (fmt.scale_y if c else 0),
                           b.w >> (fmt.scale_x if c else 0)), dtype=np.int64)
                 for c in range(ncomp)]
        out_preds[id(cu)] = preds
        for y in range(b.y, b.y + b.h, dy):
            for x in range(b.x, b.x + b.w, dx):
                rec = {"cu": cu, "x": x, "y": y, "preds": preds,
                       "h": [[None] * ncomp, [None] * ncomp],
                       "ring": [None, None]}
                for lst in range(2):
                    ref_pic = sh.ref_pics[lst][cu.ref_idx[lst]]
                    dplanes = ref_pic.device_planes
                    mv = M.clip_mv_in_pic(cu.mv[lst], x, y, dcs)
                    fx, fy = mv[0] & 15, mv[1] & 15
                    x0 = x + (mv[0] >> 4)
                    y0 = y + (mv[1] >> 4)
                    cf_h = MC.luma_coeffs(fx, dx, dy if fy == 0 else dy + 7,
                                          use_alt_hpel, True)
                    cf_v = MC.luma_coeffs(fy, dx, dy, use_alt_hpel, False)
                    rec["h"][lst][0] = batch.add_block(
                        dplanes[0], x0, y0, dx, dy, cf_h, cf_v,
                        fy != 0, False, True)
                    x_off = 1 if fx < 8 else 0
                    y_off = 1 if fy < 8 else 0
                    shift = max(2, MC.IF_INTERNAL_PREC - bd)
                    ring_src = _gather(ref_pic.planes[0], x0 - x_off,
                                            y0 - y_off, dx + 2, dy + 2)
                    rec["ring"][lst] = ((ring_src << shift)
                                        - MC.IF_INTERNAL_OFFS).astype(np.int32)
                    for comp in range(1, ncomp):
                        scx, scy = fmt.scale_x, fmt.scale_y
                        cfx = mv[0] & ((1 << (4 + scx)) - 1)
                        cfy = mv[1] & ((1 << (4 + scy)) - 1)
                        rec["h"][lst][comp] = batch.add_block(
                            dplanes[comp],
                            (x >> scx) + (mv[0] >> (4 + scx)),
                            (y >> scy) + (mv[1] >> (4 + scy)),
                            dx >> scx, dy >> scy,
                            MC._CHROMA[cfx << (1 - scx)],
                            MC._CHROMA[cfy << (1 - scy)],
                            cfy != 0, False, False)
                groups.setdefault((dx, dy), []).append(rec)
    batch.execute()
    for (dx, dy), recs in groups.items():
        exts = [[], []]
        for r in recs:
            for lst in range(2):
                ext = r["ring"][lst]
                ext[1:dy + 1, 1:dx + 1] = batch.block_result(r["h"][lst][0])
                exts[lst].append(ext)
        p0e, p1e = upload([np.stack(e) for e in exts], recon.device)
        res = to_host(RK.bdof_blend_batch(p0e, p1e, bd=bd, w=dx, h=dy)).numpy()
        for i, r in enumerate(recs):
            b = r["cu"].blocks[0]
            ly, lx = r["y"] - b.y, r["x"] - b.x
            r["preds"][0][ly:ly + dy, lx:lx + dx] = res[i].astype(np.int64)
            for comp in range(1, ncomp):
                scx, scy = fmt.scale_x, fmt.scale_y
                p0 = batch.block_result(r["h"][0][comp])
                p1 = batch.block_result(r["h"][1][comp])
                r["preds"][comp][ly >> scy:(ly + dy) >> scy,
                                 lx >> scx:(lx + dx) >> scx] = MC.bi_average(
                    p0, p1, bd)
    return out_preds


# ---------------------------------------------------------------------------
def dmvr_motion_compensation(recon, dcs, cu, bio_applied: bool):
    """xProcessDMVR: per-16x16-subPU bilateral refinement + final MC.

    Returns ([Y, Cb, Cr] predictions for the CU, refined per-4x4 motion for
    the motion field)."""
    sh = dcs.sh
    bd = recon.bit_depth
    fmt = dcs.chroma_format
    b = cu.blocks[0]
    dx = min(b.w, DMVR_SUBCU)
    dy = min(b.h, DMVR_SUBCU)
    merge_mv = [cu.mv[0], cu.mv[1]]
    ref_planes = [sh.ref_pics[0][cu.ref_idx[0]].planes,
                  sh.ref_pics[1][cu.ref_idx[1]].planes]
    preds = [np.zeros((b.h >> (fmt.scale_y if c else 0),
                       b.w >> (fmt.scale_x if c else 0)), dtype=np.int64)
             for c in range(fmt.num_components)]
    mvd_sub = {}  # (sy, sx) -> refined mvd (internal precision)
    bio_thres = 2 * dx * dy

    for sy, y in enumerate(range(b.y, b.y + b.h, dy)):
        for sx, x in enumerate(range(b.x, b.x + b.w, dx)):
            # -- luma prefetch per list (xPrefetch forLuma) --
            pre = []
            fetch_base = []
            for lst in range(2):
                cmv = (merge_mv[lst][0] - (3 << 4), merge_mv[lst][1] - (3 << 4))
                cmv = M.clip_mv_in_pic(cmv, x, y, dcs)
                fx = x + (cmv[0] >> 4)
                fy = y + (cmv[1] >> 4)
                fetch_base.append((fx, fy))
                pre.append(_gather(ref_planes[lst][0], fx, fy, dx + 7, dy + 7))
            # -- bilinear grids (dx+4)x(dy+4) (xinitMC) --
            grids = []
            for lst in range(2):
                mv_cl = M.clip_mv_in_pic(merge_mv[lst], x, y, dcs)
                grids.append(
                    _bilinear_grid(pre[lst], mv_cl[0] & 15, mv_cl[1] & 15,
                                   dx + 4, dy + 4, bd)
                )
            # -- integer search (xBIPMVRefine) --
            sads = {}

            def cost_at(dmx, dmy):
                a = grids[0][2 + dmy : 2 + dmy + dy, 2 + dmx : 2 + dmx + dx]
                c = grids[1][2 - dmy : 2 - dmy + dy, 2 - dmx : 2 - dmx + dx]
                return _sad_even_rows(a, c)

            min_cost = cost_at(0, 0)
            min_cost -= min_cost >> 2
            not_zero = True
            delta = (0, 0)
            if min_cost < dx * dy:
                not_zero = False
            else:
                sads[(0, 0)] = min_cost
                for off in _SEARCH_OFFSETS:
                    if off not in sads:
                        sads[off] = cost_at(off[0], off[1])
                    if sads[off] < min_cost:
                        min_cost = sads[off]
                        delta = off
            total = [delta[0] << 4, delta[1] << 4]
            # -- sub-pel surface (xDMVRSubPixelErrorSurface) --
            if (not_zero and abs(total[0]) != (2 << 4) and abs(total[1]) != (2 << 4)):
                cx, cy = delta
                sbuf = [
                    sads[(cx, cy)],
                    sads.get((cx - 1, cy), 1 << 62),
                    sads.get((cx, cy - 1), 1 << 62),
                    sads.get((cx + 1, cy), 1 << 62),
                    sads.get((cx, cy + 1), 1 << 62),
                ]
                sp = _subpel_error_srfc(sbuf)
                total[0] += sp[0]
                total[1] += sp[1]
            mvd = (total[0], total[1])
            mvd_sub[(sy, sx)] = mvd
            bio_sub = False if min_cost < bio_thres else bio_applied
            block_moved = mvd != (0, 0)

            # -- final padded MC (xFinalPaddedMCForDMVR) --
            sub_mv = [
                (merge_mv[0][0] + mvd[0], merge_mv[0][1] + mvd[1]),
                (merge_mv[1][0] - mvd[0], merge_mv[1][1] - mvd[1]),
            ]
            sub_ext = [None, None]
            for lst in range(2):
                cmv = sub_mv[lst]
                cmv_cl = M.clip_mv_in_pic(cmv, x, y, dcs)
                for comp in range(fmt.num_components):
                    scx = fmt.scale_x if comp else 0
                    scy = fmt.scale_y if comp else 0
                    w_c, h_c = dx >> scx, dy >> scy
                    frac_x = cmv_cl[0] & ((1 << (4 + scx)) - 1)
                    frac_y = cmv_cl[1] & ((1 << (4 + scy)) - 1)
                    if block_moved or comp == 0:
                        if comp == 0:
                            buf = pre[lst]
                            pad = DMVR_ITER
                            fb = fetch_base[lst]
                        else:
                            # chroma prefetch (xPrefetch !forLuma)
                            half = 1  # (NTAPS_CHROMA>>1)-1
                            ccmv = M.clip_mv_in_pic(
                                (merge_mv[lst][0] - (half << (4 + scx)),
                                 merge_mv[lst][1] - (half << (4 + scy))),
                                x, y, dcs)
                            cfx = (x >> scx) + (ccmv[0] >> (4 + scx))
                            cfy = (y >> scy) + (ccmv[1] >> (4 + scy))
                            buf = _gather(ref_planes[lst][comp], cfx, cfy,
                                          w_c + 3, h_c + 3)
                            pad = DMVR_ITER >> scy
                            fb = (cfx, cfy)
                        padded = _pad2(buf, pad)
                        d_int_x = (cmv[0] >> (4 + scx)) - (merge_mv[lst][0] >> (4 + scx))
                        d_int_y = (cmv[1] >> (4 + scy)) - (merge_mv[lst][1] >> (4 + scy))
                        # local block-start inside padded buffer
                        half = 3 if comp == 0 else 1
                        lx0 = pad + half + d_int_x
                        ly0 = pad + half + d_int_y
                        res = MC.mc_block(
                            padded, lx0, ly0, w_c, h_c, frac_x, frac_y,
                            comp == 0, bd, rnd_res=False,
                            use_alt_hpel=False, scale_x=scx, scale_y=scy,
                        )
                        if comp == 0 and bio_sub:
                            # extended BIO version from the padded buffer
                            shift = max(2, MC.IF_INTERNAL_PREC - bd)
                            x_off = 1 if frac_x < 8 else 0
                            y_off = 1 if frac_y < 8 else 0
                            ring_src = _gather(padded, lx0 - x_off, ly0 - y_off,
                                               w_c + 2, h_c + 2)
                            ext = (ring_src << shift) - MC.IF_INTERNAL_OFFS
                            ext[1 : h_c + 1, 1 : w_c + 1] = res
                            sub_ext[lst] = ext
                    else:
                        # chroma without refetch: direct reference MC
                        cb_x = (x >> scx) + (cmv_cl[0] >> (4 + scx))
                        cb_y = (y >> scy) + (cmv_cl[1] >> (4 + scy))
                        res = MC.mc_block(
                            ref_planes[lst][comp], cb_x, cb_y, w_c, h_c,
                            frac_x, frac_y, False, bd, rnd_res=False,
                            scale_x=scx, scale_y=scy,
                        )
                    if lst == 0:
                        if comp == 0:
                            luma0 = res
                        elif comp == 1:
                            cb0 = res
                        else:
                            cr0 = res
                    else:
                        ys0 = (y - b.y) >> scy
                        xs0 = (x - b.x) >> scx
                        if comp == 0:
                            if bio_sub:
                                blended = bdof_blend(sub_ext[0], sub_ext[1], dx, dy, bd)
                            else:
                                blended = MC.bi_average(luma0, res, bd)
                            preds[0][ys0 : ys0 + h_c, xs0 : xs0 + w_c] = blended
                        else:
                            other = cb0 if comp == 1 else cr0
                            preds[comp][ys0 : ys0 + h_c, xs0 : xs0 + w_c] = (
                                MC.bi_average(other, res, bd)
                            )
    return preds, mvd_sub, dx, dy
