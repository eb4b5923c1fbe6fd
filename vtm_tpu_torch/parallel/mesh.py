"""A mesh of lanes for the multi-device path, its halo exchanges, and the
live decode mesh.

Counterpart of vtm_tpu/parallel/mesh.py.  The reference's mesh is a
(gop, tile) grid of jax devices driven by one controller; this one is a
(gop, tile) grid of lanes in one process, each lane with its own
torch.device:
  - "gop": frame-batch data parallelism (distinct pictures per lane),
  - "tile": intra-picture spatial parallelism along the picture width.
Lanes may share a card (`["cuda:0"] * 4` on a one-card machine, "cpu" in
the tests) or sit on cards of their own (cuda:0..3 on a host with four).

The halos (the reference's ppermute inside shard_map) are two kernels,
csrc/halo.cu, each one launch for all the lanes of a card: `halo_gather`
extends every lane's shard by its neighbours' edge rows or columns (the
ring's wrap at the mesh's ends for `halo_exchange`, an edge replica for the
sharded filter chain), and `halo_add_deltas` returns the deblocking's edge
deltas to the lanes that own those samples.  A lane reads a neighbour on
its own card in place; a neighbour's strip on another card is copied over
first, h columns or rows and no more.  On CPU tensors both take their
plain versions (torch.cat, edge_pad, slices).

`decode_mesh_ctx(mesh)` makes the decoder run sharded (the reference's
L96-117): while it is active, every MC batch splits its job axis over all
the lanes (ops/mc_kernel.py) and the in-loop chain width-shards its luma
over the 'tile' lanes of gop row 0 (ops/filter_chain.py ->
parallel/pic_shard.py:run_chain_on_mesh).
"""

from __future__ import annotations

import ctypes
from contextlib import contextmanager

import torch

from vtm_tpu_torch import kernels as KN
from vtm_tpu_torch.device import resolve_device
from vtm_tpu_torch.ops import edge_pad, pick
from vtm_tpu_torch.ops.filter_chain import host_tensor
from vtm_tpu_torch.ops.transform import inv_transform_batch


class CodecMesh:
    """`devices` (one per lane, in gop-major order) as a gop x tile grid.
    `routes`: the route of each picture's chain that the live decode mesh
    ran on this mesh, in decode order (pic_shard.run_chain_on_mesh)."""

    def __init__(self, devices, gop: int, tile: int):
        self.devices = [resolve_device(d) for d in devices]
        if len(self.devices) != gop * tile:
            raise ValueError(f"{len(self.devices)} lanes cannot form a "
                             f"{gop} x {tile} mesh")
        self.gop, self.tile = gop, tile
        self.shape = {"gop": gop, "tile": tile}
        self.routes: list[dict] = []

    @property
    def size(self) -> int:
        return self.gop * self.tile

    def lane(self, g: int, t: int) -> torch.device:
        return self.devices[g * self.tile + t]

    def check_home(self, device) -> torch.device:
        """Raise ValueError unless lane (0, 0) is `device` (the decoder's)
        and every lane is of its type (lanes may sit on other cards, never
        on the CPU when the decoder is on a card); returns lane (0, 0)."""
        home, device = self.devices[0], torch.device(device)
        if home != device:
            raise ValueError(f"decode mesh lane (0, 0) is on {home}, the decoder on "
                             f"{device}")
        other = sorted({str(d) for d in self.devices if d.type != device.type})
        if other:
            raise ValueError(f"decode mesh lanes on {other}, the decoder on {device}")
        return home


def codec_mesh(n: int, gop: int | None = None, device="cuda") -> CodecMesh:
    """n lanes factored into a (gop, tile) mesh as the reference factors its
    devices (gop 2 when n is even and above 1).  `device` is one device for
    every lane ("cpu"; "cuda" spreads the lanes over the cards round robin,
    so they share a card when there is one) or a list of n devices."""
    if isinstance(device, (list, tuple)):
        devices = list(device)
        if len(devices) != n:
            raise ValueError(f"{len(devices)} devices for {n} lanes")
    elif str(device) == "cuda":
        resolve_device("cuda")
        k = torch.cuda.device_count()
        devices = [f"cuda:{i % k}" for i in range(n)]
    else:
        devices = [device] * n
    if gop is None:
        gop = 2 if n % 2 == 0 and n > 1 else 1
    tile = n // gop
    return CodecMesh(devices[:gop * tile], gop, tile)


# ---------------------------------------------------------------------------
# halo exchanges (csrc/halo.cu)

# lanes of one card a halo launch takes (csrc/halo.cu HALO_MAX_LANES)
HALO_MAX_LANES = 32


def _edge(x: torch.Tensor, axis: int, at: int, h: int) -> torch.Tensor:
    """x's row or column `at` along `axis`, repeated h times."""
    return x.narrow(axis, at, 1).expand(*(h if k == axis else -1 for k in (0, 1)))


def halo_gather_plain(shards, h: int, axis: int = 1, wrap: bool = False,
                      pad: int = 0):
    """Each lane's 2-D shard extended by h rows (axis 0) or columns (axis 1)
    from the previous and the next lane, on the lane's own device; at the
    mesh's ends the ring's wrap (`wrap`) or the shard's own edge,
    replicated; then edge-padded by `pad` across the other axis."""
    n = len(shards)
    out = []
    for i, x in enumerate(shards):
        if wrap or i > 0:
            p = shards[(i - 1) % n]
            before = p.narrow(axis, p.shape[axis] - h, h).to(x.device)
        else:
            before = _edge(x, axis, 0, h)
        if wrap or i < n - 1:
            after = shards[(i + 1) % n].narrow(axis, 0, h).to(x.device)
        else:
            after = _edge(x, axis, x.shape[axis] - 1, h)
        ext = torch.cat([before, x, after], dim=axis)
        if pad:
            ext = edge_pad(ext, pad, 0) if axis == 1 else edge_pad(ext, 0, pad)
        out.append(ext)
    return out


def _lanes_by_device(tensors) -> dict:
    """{device: [lane index]} in lane order; at most HALO_MAX_LANES a card."""
    by = {}
    for i, t in enumerate(tensors):
        by.setdefault(t.device, []).append(i)
    for dev, idx in by.items():
        if len(idx) > HALO_MAX_LANES:
            raise ValueError(f"{len(idx)} lanes on {dev}, at most {HALO_MAX_LANES}")
    return by


def _source(t: torch.Tensor, axis: int, start: int, h: int, dev, keep: list):
    """(pointer, row stride, offset along `axis`) of the h rows or columns of
    `t` from `start` as a kernel on `dev` reads them: in place on its own
    card; else from a copy of that strip alone on `dev` (kept alive in
    `keep` until the launch is queued on the stream it was made on)."""
    if t.device == dev:
        return t.data_ptr(), t.shape[1], start
    strip = t.narrow(axis, start, h).contiguous().to(dev)
    keep.append(strip)
    return strip.data_ptr(), strip.shape[1], 0


def halo_gather_cuda(shards, h: int, axis: int = 1, wrap: bool = False,
                     pad: int = 0):
    """halo_gather_plain through csrc/halo.cu: one vtm_halo_gather launch
    for the lanes of each card."""
    n = len(shards)
    if not n or h < 1 or pad < 0 or axis not in (0, 1):
        raise ValueError(f"halo_gather: {n} shards, h {h}, pad {pad}, axis {axis}")
    across = shards[0].shape[1 - axis]
    for i, x in enumerate(shards):
        KN.check(x, f"shard {i}", torch.int32, x.device)
        if x.dim() != 2 or x.shape[1 - axis] != across:
            raise ValueError(f"halo_gather: shard {i} {tuple(x.shape)} does not "
                             f"share the other shards' {across} across axis {axis}")
        if (wrap or n > 1) and x.shape[axis] < h:
            raise ValueError(f"halo_gather: shard {i} is {x.shape[axis]} wide along "
                             f"axis {axis}, less than the halo {h}")
    outs = []
    for x in shards:
        ext = [across + 2 * pad, x.shape[axis] + 2 * h]
        outs.append(torch.empty(ext if axis == 1 else ext[::-1], dtype=torch.int32,
                                device=x.device))
    for dev, idx in _lanes_by_device(shards).items():
        words, keep = [], []
        for i in idx:
            nb = []
            for j, start in ((i - 1, -h), (i + 1, 0)):
                if not (wrap or 0 <= j < n):
                    nb.append((0, 0, 0))
                    continue
                y = shards[j % n]
                nb.append(_source(y, axis, start % y.shape[axis], h, dev, keep))
            words += [shards[i].data_ptr(), outs[i].data_ptr(), nb[0][0], nb[1][0],
                      shards[i].shape[axis], nb[0][1], nb[1][1], nb[0][2], nb[1][2]]
        table = (ctypes.c_uint64 * len(words))(*words)
        KN.launch("vtm_halo_gather", dev, ctypes.addressof(table), len(idx), across,
                  h, pad, int(axis == 1))
    return outs


def halo_gather(shards, h: int, axis: int = 1, wrap: bool = False, pad: int = 0):
    """The lanes' extended shards (halo_gather_plain): the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors."""
    return pick(shards[0], halo_gather_cuda, halo_gather_plain)(
        shards, h, axis=axis, wrap=wrap, pad=pad)


def halo_exchange(shards, halo: int):
    """Each lane's (rows, w) shard extended by `halo` rows from the previous
    and the next lane: (halo + rows + halo, w) on the lane's own device.
    The first and last lanes get the wrap-around rows, as with the
    reference's ppermute ring; callers mask them."""
    return halo_gather(shards, halo, axis=0, wrap=True)


def halo_add_deltas_plain(shards, deltas, h: int):
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


def halo_add_deltas_cuda(shards, deltas, h: int):
    """halo_add_deltas_plain through csrc/halo.cu: one vtm_halo_add_deltas
    launch for the lanes of each card."""
    n = len(shards)
    if not n or len(deltas) != n or h < 1:
        raise ValueError(f"halo_add_deltas: {n} shards, {len(deltas)} deltas, h {h}")
    rows = shards[0].shape[0]
    for i, (x, d) in enumerate(zip(shards, deltas)):
        KN.check(x, f"shard {i}", torch.int32, x.device)
        if x.dim() != 2 or x.shape[0] != rows or x.shape[1] < h:
            raise ValueError(f"halo_add_deltas: shard {i} {tuple(x.shape)}, {rows} rows "
                             f"of at least {h} columns expected")
        KN.check(d, f"deltas {i}", torch.int32, x.device, (rows, x.shape[1] + 2 * h))
    outs = [torch.empty_like(x) for x in shards]
    for dev, idx in _lanes_by_device(shards).items():
        words, keep = [], []
        for i in idx:
            nb = [(0, 0, 0) if i == 0 else
                  _source(deltas[i - 1], 1, deltas[i - 1].shape[1] - h, h, dev, keep),
                  (0, 0, 0) if i == n - 1 else _source(deltas[i + 1], 1, 0, h, dev, keep)]
            words += [shards[i].data_ptr(), deltas[i].data_ptr(), outs[i].data_ptr(),
                      nb[0][0], nb[1][0], shards[i].shape[1], nb[0][1], nb[1][1],
                      nb[0][2], nb[1][2]]
        table = (ctypes.c_uint64 * len(words))(*words)
        KN.launch("vtm_halo_add_deltas", dev, ctypes.addressof(table), len(idx), rows, h)
    return outs


def halo_add_deltas(shards, deltas, h: int):
    """The deblocking's delta return (halo_add_deltas_plain): the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    return pick(shards[0], halo_add_deltas_cuda, halo_add_deltas_plain)(shards, deltas, h)


# ---------------------------------------------------------------------------
# sharded reconstruction step


def recon_sse_plain(resid, pred, orig):
    """(int16 clip(pred + resid, 0, 255), int64 (1,) sum of (recon - orig)^2)."""
    recon = (pred + resid).clamp(0, 255)
    d = (recon - orig).to(torch.int64)
    return recon.to(torch.int16), (d * d).sum().reshape(1)


def recon_sse_cuda(resid, pred, orig):
    dev = resid.device
    for name, t in (("resid", resid), ("pred", pred), ("orig", orig)):
        KN.check(t, name, torch.int32, dev, tuple(resid.shape))
    recon = torch.empty(resid.shape, dtype=torch.int16, device=dev)
    sse = torch.empty(1, dtype=torch.int64, device=dev)
    KN.launch("vtm_recon_sse", dev, resid.data_ptr(), pred.data_ptr(),
              orig.data_ptr(), recon.data_ptr(), sse.data_ptr(), resid.numel())
    return recon, sse


def recon_sse(resid, pred, orig):
    """One lane's reconstruction and its exact SSE partial: the CUDA kernel
    for CUDA tensors, the plain version for CPU tensors."""
    return pick(resid, recon_sse_cuda, recon_sse_plain)(resid, pred, orig)


def sharded_recon_step(mesh: CodecMesh, coeff, pred, orig):
    """Inverse transform + reconstruction of (F, T, N, N) int32 blocks split
    F over 'gop' and T over 'tile', and the SSE summed over every lane.
    Per lane: the int32 transform kernel (8-bit), then the recon/SSE
    kernel; the lanes' int64 partials are summed exactly, then converted to
    float32.  Returns (int16 recon (F, T, N, N), float32 SSE (1,)), both on
    the first lane's device."""
    coeff, pred, orig = (a if torch.is_tensor(a) else host_tensor(a)
                         for a in (coeff, pred, orig))
    F, T, N, _ = coeff.shape
    if F % mesh.gop or T % mesh.tile:
        raise ValueError(f"(F, T) = {(F, T)} does not split over a "
                         f"{mesh.gop} x {mesh.tile} mesh")
    fs, ts = F // mesh.gop, T // mesh.tile
    home = mesh.devices[0]
    rows, partials = [], []
    for g in range(mesh.gop):
        row = []
        for t in range(mesh.tile):
            dev = mesh.lane(g, t)
            sl = (slice(g * fs, (g + 1) * fs), slice(t * ts, (t + 1) * ts))
            c, p, o = (a[sl].to(dev, torch.int32).contiguous()
                       for a in (coeff, pred, orig))
            resid = inv_transform_batch(c.reshape(fs * ts, N, N), 8).reshape(c.shape)
            recon, sse = recon_sse(resid, p, o)
            row.append(recon.to(home))
            partials.append(sse.to(home))
        rows.append(torch.cat(row, dim=1))
    total = torch.stack(partials).sum()
    return torch.cat(rows, dim=0), total.to(torch.float32).reshape(1)


# ---------------------------------------------------------------------------
# the live decode mesh

_DECODE_MESH = None


def decode_mesh() -> CodecMesh | None:
    """The active decode mesh, or None (the decoder runs on its device)."""
    return _DECODE_MESH


@contextmanager
def decode_mesh_ctx(mesh: CodecMesh):
    """Run the decoder's MC batches and in-loop chains sharded over `mesh`
    while the block runs; the previous mesh (or none) comes back after it."""
    global _DECODE_MESH
    prev = _DECODE_MESH
    _DECODE_MESH = mesh
    try:
        yield mesh
    finally:
        _DECODE_MESH = prev
