"""A mesh of lanes for the multi-device path, and its halo exchange.

Counterpart of vtm_tpu/parallel/mesh.py:20-86.  The reference's mesh is a
(gop, tile) grid of jax devices driven by one controller; this one is a
(gop, tile) grid of lanes in one process, each lane with its own
torch.device:
  - "gop": frame-batch data parallelism (distinct pictures per lane),
  - "tile": intra-picture spatial parallelism along the picture width.
Lanes may share a card (`["cuda:0"] * 4` on a one-card machine, "cpu" in
the tests) or sit on cards of their own (cuda:0..3 on a host with four).
A halo is a tensor copy between lane tensors: a peer copy over NVLink
between two cards, a copy on the card itself when the lanes share one.

Not carried over: the live decode mesh (`decode_mesh_ctx`), whose sharded
filter chain fails on any stream with loop filters in the reference.
"""

from __future__ import annotations

import torch

from vtm_tpu_torch import kernels as KN
from vtm_tpu_torch.device import resolve_device
from vtm_tpu_torch.ops import pick
from vtm_tpu_torch.ops.filter_chain import to_device
from vtm_tpu_torch.ops.transform import inv_transform_batch


class CodecMesh:
    """`devices` (one per lane, in gop-major order) as a gop x tile grid."""

    def __init__(self, devices, gop: int, tile: int):
        self.devices = [resolve_device(d) for d in devices]
        if len(self.devices) != gop * tile:
            raise ValueError(f"{len(self.devices)} lanes cannot form a "
                             f"{gop} x {tile} mesh")
        self.gop, self.tile = gop, tile
        self.shape = {"gop": gop, "tile": tile}

    @property
    def size(self) -> int:
        return self.gop * self.tile

    def lane(self, g: int, t: int) -> torch.device:
        return self.devices[g * self.tile + t]


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


def halo_exchange(shards, halo: int):
    """Each lane's (rows, w) shard extended by `halo` rows from the previous
    and the next lane: (halo + rows + halo, w) on the lane's own device.
    The first and last lanes get the wrap-around rows, as with the
    reference's ppermute ring; callers mask them."""
    n = len(shards)
    return [torch.cat([shards[(i - 1) % n][-halo:].to(x.device), x,
                       shards[(i + 1) % n][:halo].to(x.device)])
            for i, x in enumerate(shards)]


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
    coeff, pred, orig = (a if torch.is_tensor(a) else to_device(a, "cpu")
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
