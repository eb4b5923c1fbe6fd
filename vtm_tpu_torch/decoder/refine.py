"""Batched DMVR and BDOF of the port.

Forks of vtm_tpu/decoder/refine.py:dmvr_batch and bdof_batch
(InterPrediction.cpp xProcessDMVR:1997, applyBiOptFlow:1233) on the port's
kernels (ops/refine_kernel.py, ops/mc_kernel.py) and the decoder's torch
device, without the reference's batch-size buckets.  The window gathers and
every scalar helper are the reference's (`_ref`).

The prefetch windows and the BDOF rings are read from the reference
pictures' host planes (`Picture.planes`), as in the reference: on a GPU
that fetches each reference picture from the card once.
"""

from __future__ import annotations

import numpy as np

from vtm_tpu.decoder import motion as M
from vtm_tpu.decoder import refine as _ref
from vtm_tpu.ops import mc as MC
from vtm_tpu_torch.ops import refine_kernel as RK
from vtm_tpu_torch.ops import upload
from vtm_tpu_torch.ops.mc_kernel import McBatch


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
        dx = min(b.w, _ref.DMVR_SUBCU)
        dy = min(b.h, _ref.DMVR_SUBCU)
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
                padded = _ref._padded_plane_i32(pic, comp, pad_p)
                buf[m] = _ref._windows(padded, pad_p, ox[m], oy[m], wh, ww)
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
        search = search.cpu().numpy()
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
        flat = RK.dmvr_final_pack(largs[0], largs[1], cargs, w=dx, h=dy,
                                  wc=w_c, hc=h_c, bd=bd).cpu().numpy()
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
            blended[bio_idx] = res.cpu().numpy().astype(np.int64)

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
        dx = min(_ref.MAX_BDOF_REGION, b.w)
        dy = min(_ref.MAX_BDOF_REGION, b.h)
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
                    ring_src = _ref._gather(ref_pic.planes[0], x0 - x_off,
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
        res = RK.bdof_blend_batch(p0e, p1e, bd=bd, w=dx, h=dy).cpu().numpy()
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
