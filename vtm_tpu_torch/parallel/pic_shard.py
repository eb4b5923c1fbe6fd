"""Spatial (intra-picture) and frame-batch sharding of the sample pipeline
over a mesh of lanes.

Counterpart of vtm_tpu/parallel/pic_shard.py:31-231.  On a (gop, tile)
`CodecMesh` (parallel/mesh.py):
  - the whole-plane luma in-loop filter chain, width-sharded on 'tile'
    with distinct pictures on 'gop': deblock VER with an 8-column halo and
    the return of each lane's edge deltas to its neighbours, deblock HOR on
    the transpose, SAO with a 1-column halo, ALF classification and
    filtering with a 4-column halo;
  - the batched translational-MC tile kernel, its job axis split over every
    lane;
  - the full in-loop chain (LMCS, deblock, SAO, ALF / CC-ALF, every
    component), gop-batched: each 'gop' lane runs distinct pictures.
The reference's `vmap` over the pictures of a lane is a loop here, and its
ppermute halos are copies between lane tensors (`_halo_cols`).  Picture
borders replicate edges as the single-device kernels do, so every lane's
output equals its picture's single-lane result.

The arguments follow the reference's: numpy arrays (or tensors) of every
picture, in the layout the reference's capture of a decode holds them.
"""

from __future__ import annotations

import torch

from vtm_tpu_torch.ops import alf_kernel as AK
from vtm_tpu_torch.ops import deblock_kernel as DK
from vtm_tpu_torch.ops import edge_pad
from vtm_tpu_torch.ops import sao_kernel as SK
from vtm_tpu_torch.ops.filter_chain import chain_body, to_device
from vtm_tpu_torch.ops.mc_kernel import mc_tiles


def _t(a) -> torch.Tensor:
    """A tensor as it is; a numpy array as a host tensor (bool stays bool,
    integers become int32)."""
    return a if torch.is_tensor(a) else to_device(a, "cpu")


def _on(a: torch.Tensor, dev) -> torch.Tensor:
    return a.to(dev).contiguous()


def _halo_cols(shards, h: int):
    """Each lane's [H, Wl] shard extended by h columns from its width-axis
    neighbours: [H, Wl + 2h]; the picture's left and right borders are
    edge-replicated."""
    n = len(shards)
    out = []
    for i, x in enumerate(shards):
        left = (shards[i - 1][:, -h:].to(x.device) if i > 0
                else x[:, :1].expand(-1, h))
        right = (shards[i + 1][:, :h].to(x.device) if i < n - 1
                 else x[:, -1:].expand(-1, h))
        out.append(torch.cat([left, x, right], dim=1))
    return out


def add_halo_deltas(shards, deltas, h: int):
    """Each lane's [H, Wl] shard plus its deltas [H, Wl + 2h] over its own
    columns and the deltas its width-axis neighbours computed for its first
    and last h columns (their halo columns)."""
    n = len(shards)
    out = []
    for i, x in enumerate(shards):
        x = x + deltas[i][:, h:-h]
        if i > 0:
            x[:, :h] += deltas[i - 1][:, -h:].to(x.device)
        if i < n - 1:
            x[:, -h:] += deltas[i + 1][:, :h].to(x.device)
        out.append(x)
    return out


def _split_cols(a: torch.Tensor, n: int, devs, axis: int = -1):
    """a split into n equal parts along `axis`, part i on devs[i]."""
    w = a.shape[axis] // n
    return [_on(a.narrow(axis, i * w, w), d) for i, d in enumerate(devs)]


def make_sharded_luma_filters(mesh, have_sao: bool, have_alf: bool, bd: int):
    """The sharded luma filter chain.  The returned fn takes, for B pictures
    (B a multiple of mesh.gop; lane g of 'gop' runs pictures g*B/gop ..):
      x [B, H, W]; dv (7 maps [B, H4, W4]); dh (7 maps [B, W4, H4],
      transposed); sao (tmap, cmap [B, H, W], offs [B, nctu, 32],
      valid [B, H, W]) if have_sao; alf (cperm, lperm [B, ...],
      ctu_of [B, H4, W4], then o_rows, near, y_i, yd_i, yu_i, yu2_i, df, dl,
      mult shared by all pictures) if have_alf;
    and returns the filtered [B, H, W] int32 on the first lane's device."""
    n = mesh.tile

    def picture(lanes, x, dv, dh, sao, alf):
        """One picture over the tile lanes `lanes`; x and the maps on the
        host, split here."""
        xs = _split_cols(x, n, lanes)
        # deblock VER: 8-column halo, each lane's edge deltas returned
        dvs = list(zip(*(_split_cols(m, n, lanes) for m in dv)))
        acc = [DK.luma_ver_delta(e, *m, bd) for e, m in
               zip(_halo_cols(xs, 8), dvs)]
        xs = add_halo_deltas(xs, acc, 8)
        # deblock HOR: column-local after the transpose
        dhs = list(zip(*(_split_cols(m, n, lanes, axis=0) for m in dh)))
        for i in range(n):
            xt = xs[i].T
            padh = edge_pad(xt, 0, 8)
            xs[i] = (xt + DK.luma_ver_delta(padh, *dhs[i], bd)[:, 8:-8]).T.contiguous()
        if sao is not None:
            tmap, cmap, offs, valid = sao
            parts = [_split_cols(m, n, lanes) for m in (tmap, cmap, valid)]
            ext = _halo_cols(xs, 1)
            xs = [SK.sao_apply_ext(edge_pad(ext[i], 1, 0), parts[0][i], parts[1][i],
                                   _on(offs, lanes[i]), parts[2][i], bd)
                  for i in range(n)]
        if alf is not None:
            cperm, lperm, ctu_of, *rows = alf
            ctus = _split_cols(ctu_of, n, lanes)
            ext = _halo_cols(xs, 4)
            for i, d in enumerate(lanes):
                p4 = edge_pad(ext[i], AK.PAD, 0)
                o_rows, near, *cls_rows = (_on(r, d) for r in rows)
                cls, tr = AK.classify_picture(p4, *cls_rows, bit_depth=bd)
                cp, lp = _on(cperm, d), _on(lperm, d)
                gather = (ctus[i].long(), cls.long(), tr.long())
                xs[i] = AK.alf_filter(p4, cp[gather], lp[gather], o_rows, near,
                                      taps=AK.LUMA_TAPS, bit_depth=bd)
        home = mesh.devices[0]
        return torch.cat([a.to(home) for a in xs], dim=1)

    def fn(x, dv, dh, *rest):
        rest = list(rest)
        sao = rest.pop(0) if have_sao else None
        alf = rest.pop(0) if have_alf else None
        x = _t(x)
        dv, dh = [_t(m) for m in dv], [_t(m) for m in dh]
        sao = None if sao is None else [_t(m) for m in sao]
        alf = None if alf is None else [_t(m) for m in alf]
        B = x.shape[0]
        if B % mesh.gop:
            raise ValueError(f"{B} pictures do not split over {mesh.gop} gop lanes")
        per = B // mesh.gop
        out = []
        for b in range(B):
            g = b // per
            lanes = [mesh.lane(g, t) for t in range(n)]
            out.append(picture(
                lanes, x[b], [m[b] for m in dv], [m[b] for m in dh],
                None if sao is None else [m[b] for m in sao],
                None if alf is None else [m[b] for m in alf[:3]] + alf[3:]))
        return torch.stack(out)

    return fn


def split_mc_jobs(cap, n_dev: int):
    """A captured MC tile batch's job arrays split over n_dev lanes, padded
    with zero jobs to a multiple of n_dev (as the reference pads): (refs
    [R, H, W], [lane i's job arrays for i < n_dev]), on the host.
    cap: {"args": (refs [R, H, W], r, x, y, ch, cv, fy, rnd), ...}."""
    refs, *jobs = (_t(a) for a in cap["args"])
    nb = jobs[0].shape[0]
    npad = -(-nb // n_dev) * n_dev
    share = npad // n_dev

    def padn(a):
        out = torch.zeros((npad,) + tuple(a.shape[1:]), dtype=a.dtype)
        out[:nb] = a
        return out

    jobs = [padn(a) for a in jobs]
    return refs, [[a[i * share:(i + 1) * share] for a in jobs] for i in range(n_dev)]


def sharded_mc_tiles(mesh, cap):
    """A captured MC tile batch with its job axis split over every lane
    (split_mc_jobs); the reference planes are copied to each lane.
    cap: {"args": (refs [R, H, W], r, x, y, ch, cv, fy, rnd), "taps",
    "tile", "bd"}.  Returns the [N, tile, tile] results on the first lane's
    device."""
    refs, shares = split_mc_jobs(cap, mesh.size)
    home = mesh.devices[0]
    outs = []
    for dev, part in zip(mesh.devices, shares):
        planes = [_on(p, dev) for p in refs]
        outs.append(mc_tiles(planes, *(_on(a, dev) for a in part), taps=cap["taps"],
                             tile=cap["tile"], bd=cap["bd"]).to(home))
    return torch.cat(outs)[:cap["args"][1].shape[0]]


def full_chain_sig(c):
    """Static signature of a full-chain capture (pictures that batch)."""
    def shp(v):
        if v is None:
            return None
        if isinstance(v, (tuple, list)):
            return tuple(shp(x) for x in v)
        return tuple(v.shape)
    return (c["fl"], c["bd"], c["sx"], c["sy"], shp(c["y"]), shp(c["cb"]),
            shp(c["dbv"]), shp(c["dbh"]), shp(c["sao"]), shp(c["alf"]),
            None if c["lmcs"] is None else tuple(c["lmcs"].shape))


def run_full_chain_gop(mesh, caps):
    """Gop-batched full in-loop chain: every 'gop' lane runs distinct
    pictures (the captures cycled up to a multiple of mesh.gop) through the
    port's chain_body on the lane's device.  Each capture holds one
    picture's chain inputs as the reference captures them: y, cb, cr, lmcs,
    dbv, dbh (17 maps or None), sao (3 entries of 4 maps, or None), alf (22
    tables or None), fl, bd, sx, sy.  Returns (packed outputs [B, n] on the
    first lane's device, the captures in lane order)."""
    g = mesh.gop
    b = len(caps)
    sel = [caps[i % b] for i in range(-(-b // g) * g)]
    per = len(sel) // g
    home = mesh.devices[0]

    def put(v, dev):
        if v is None:
            return None
        if isinstance(v, (tuple, list)):
            return type(v)(put(x, dev) for x in v)
        return _on(_t(v), dev)

    out = []
    for i, c in enumerate(sel):
        dev = mesh.lane(i // per, 0)
        y = put(c["y"], dev)
        cb, cr = put(c["cb"], dev), put(c["cr"], dev)
        lut = put(c["lmcs"], dev) if c["lmcs"] is not None else None
        sao = [put(s, dev) for s in c["sao"]] if c["sao"] is not None else None
        packed = chain_body(y, cb, cr, lut, put(c["dbv"], dev), put(c["dbh"], dev),
                            sao, put(c["alf"], dev), c["bd"], c["sx"], c["sy"],
                            tuple(c["fl"]))
        out.append(packed.to(home))
    return torch.stack(out), sel
