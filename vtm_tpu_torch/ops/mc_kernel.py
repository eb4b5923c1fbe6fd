"""Batched translational motion compensation: plain torch version, CUDA
wrapper and the per-slice batch.

Counterpart of vtm_tpu/ops/mc_kernel.py.  All translational MC of a slice
runs as one kernel call per component class: blocks are cut into fixed
tiles (4x4 luma, 2x2 chroma), each tile's window is read from its
reference plane with rows and columns clamped to the plane (edge
replication), and a uniform two-pass FIR gives either the 14-bit
intermediate (bi) or the final clipped sample (uni).

Why one branch-free form covers VTM's four filter paths
(InterpolationFilter.cpp filter / filterCopy, mirrored by ops/mc.py):
- the H(first, notLast) pass with the phase-0 identity row equals
  filterCopy(first, notLast): (64x - OFFS<<s) >> s == (x<<hr) - OFFS;
- the V(notFirst, notLast) pass with identity is exact: (64t) >> 6 == t;
- for the final (isLast) stage, V(notFirst, last) on the uniform
  intermediate is exact for fy != 0 (both fx cases), and copyLast on the
  uniform intermediate is exact for fy == 0 (both fx cases):
  ((sum c x) >> s - OFFS + OFFS + 2^(hr-1)) >> hr == (sum c x + 32) >> 6,
  because the dropped low s bits never reach the bit-5 rounding (s < 6).

* CPU tensors: `mc_tiles_plain`.
* CUDA tensors: csrc/mc.cu, a group of tiles a block, their windows in
  shared memory, a thread a tile column; the reference planes reach it by
  value, as up to MAX_PLANES pointers in its kernel parameters (no
  stacking, no copy to the card).

While a decode mesh is active (parallel/mesh.py:decode_mesh_ctx),
`execute_many` splits each component class's job axis over every lane of
the mesh (the reference's L246-258, where GSPMD partitions the batch).

Not carried over from the reference: batch-size buckets and the
power-of-two padding of the plane stack (they bounded XLA compiles) and
the CAPTURE hook.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from vtm_tpu_torch import kernels as KN
from vtm_tpu_torch import trace
from vtm_tpu_torch.ops import clamp_index, pick, to_host, upload

IF_INTERNAL_PREC = 14
IF_OFFS = 1 << (IF_INTERNAL_PREC - 1)
# component class -> (taps, tile)
SHAPES = {True: (8, 4), False: (4, 2)}
# reference planes a kernel call takes (csrc/mc.cu MC_MAX_PLANES)
MAX_PLANES = 256


def mc_tiles_plain(refs, r_idx, x0, y0, cH, cV, fy_nz, rnd, taps: int,
                   tile: int, bd: int):
    """Batched tile MC.

    refs:  sequence of R int32 [H, W] reference planes (one class).
    r_idx: int32 [N] plane index per tile.
    x0,y0: int32 [N] top-left of the FIR support window
           (block_x + int_mv - (taps/2 - 1)).
    cH,cV: int32 [N, taps] filter coefficients (phase already selected;
           identity row for frac 0).
    fy_nz: bool [N] vertical phase non-zero (selects the isLast variant).
    rnd:   bool [N] True: final clipped sample (uni); False: 14-bit
           intermediate (bi).
    Returns int32 [N, tile, tile]."""
    stack = torch.stack(list(refs))
    R, H, W = stack.shape
    n = taps
    hr = max(2, IF_INTERNAL_PREC - bd)
    s1 = 6 - hr
    off1 = -(IF_OFFS << s1)
    maxv = (1 << bd) - 1
    span = torch.arange(tile + n - 1, dtype=torch.int32, device=stack.device)
    iy = clamp_index(y0[:, None] + span, H)
    ix = clamp_index(x0[:, None] + span, W)
    win = stack[clamp_index(r_idx, R)[:, None, None], iy[:, :, None], ix[:, None, :]]
    N = win.shape[0]
    # H pass: isFirst, notLast
    tmp = torch.zeros((N, tile + n - 1, tile), dtype=torch.int32, device=win.device)
    for k in range(n):
        tmp = tmp + cH[:, k, None, None] * win[:, :, k:k + tile]
    tmp = (tmp + off1) >> s1
    # V pass: notFirst, notLast -> intermediate
    acc = torch.zeros((N, tile, tile), dtype=torch.int32, device=win.device)
    for k in range(n):
        acc = acc + cV[:, k, None, None] * tmp[:, k:k + tile, :]
    inter = acc >> 6
    # final stage variants for uni
    shl = 6 + hr
    offl = (1 << (shl - 1)) + (IF_OFFS << 6)
    r_v = ((acc + offl) >> shl).clamp(0, maxv)
    r_c = ((inter + IF_OFFS + (1 << (hr - 1))) >> hr).clamp(0, maxv)
    uni = torch.where(fy_nz[:, None, None], r_v, r_c)
    return torch.where(rnd[:, None, None], uni, inter)


def mc_tiles_cuda(refs, r_idx, x0, y0, cH, cV, fy_nz, rnd, taps: int,
                  tile: int, bd: int, out: torch.Tensor | None = None):
    """csrc/mc.cu on the same arguments; writes into `out` when given.  The
    plane pointers go to the kernel as a host array: no copy to the card."""
    dev = r_idx.device
    planes = list(refs)
    if not planes:
        raise ValueError("mc_tiles: no reference plane")
    if len(planes) > MAX_PLANES:
        raise ValueError(f"mc_tiles: {len(planes)} reference planes, at most "
                         f"{MAX_PLANES} a call")
    H, W = planes[0].shape
    for p in planes:
        KN.check(p, "refs", torch.int32, dev, (H, W))
    N = r_idx.shape[0]
    for name, a, shape in (("r_idx", r_idx, (N,)), ("x0", x0, (N,)),
                           ("y0", y0, (N,)), ("cH", cH, (N, taps)),
                           ("cV", cV, (N, taps))):
        KN.check(a, name, torch.int32, dev, shape)
    KN.check(fy_nz, "fy_nz", torch.bool, dev, (N,))
    KN.check(rnd, "rnd", torch.bool, dev, (N,))
    if out is None:
        out = torch.empty((N, tile, tile), dtype=torch.int32, device=dev)
    KN.check(out, "out", torch.int32, dev, (N, tile, tile))
    if N == 0:
        return out
    table = (ctypes.c_void_p * len(planes))(*(p.data_ptr() for p in planes))
    KN.launch("vtm_mc_tiles", dev, ctypes.addressof(table), len(planes), H, W,
              r_idx.data_ptr(), x0.data_ptr(), y0.data_ptr(), cH.data_ptr(),
              cV.data_ptr(), fy_nz.data_ptr(), rnd.data_ptr(), N, taps, tile,
              bd, out.data_ptr())
    return out


def mc_tiles(refs, r_idx, x0, y0, cH, cV, fy_nz, rnd, taps: int, tile: int,
             bd: int):
    """Tile MC: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    fn = pick(r_idx, mc_tiles_cuda, mc_tiles_plain)
    return fn(refs, r_idx, x0, y0, cH, cV, fy_nz, rnd, taps=taps, tile=tile,
              bd=bd)


def mc_tiles_pair(largs, cargs, bd: int) -> torch.Tensor:
    """Luma and chroma tile batches (either may be None) into one flat int32
    output, luma first, so that one device-to-host copy fetches both."""
    parts = [(a, SHAPES[lum]) for a, lum in ((largs, True), (cargs, False))
             if a is not None]
    if not parts:
        raise ValueError("mc_tiles_pair: no batch")
    r_idx = parts[0][0][1]
    on_cuda = pick(r_idx, True, False)
    sizes = [a[1].shape[0] * tile * tile for a, (_, tile) in parts]
    flat = torch.empty(sum(sizes), dtype=torch.int32, device=r_idx.device)
    pos = 0
    for (args, (taps, tile)), size in zip(parts, sizes):
        view = flat[pos:pos + size].view(-1, tile, tile)
        if on_cuda:
            mc_tiles_cuda(*args, taps=taps, tile=tile, bd=bd, out=view)
        else:
            view.copy_(mc_tiles_plain(*args, taps=taps, tile=tile, bd=bd))
        pos += size
    return flat


def execute_many(batches) -> None:
    """Run several McBatch instances together: per component class, all
    their tiles go into one kernel call over the union of their reference
    planes (one call a lane while a decode mesh is active: mesh_pair), and
    one device-to-host copy brings every result back; under torch.profiler
    the span `inter.mc` (trace.py)."""
    batches = [b for b in batches if b.n[True] or b.n[False]]
    if not batches:
        return
    with trace.span("inter.mc"):
        bd, dev = batches[0].bd, batches[0].device
        for b in batches:
            if b.bd != bd or b.device != dev:
                raise ValueError("execute_many: batches differ in bit depth or device")
        from vtm_tpu_torch.parallel import mesh as MESH

        dmesh = MESH.decode_mesh()
        cols = {}
        for lum in (True, False):
            planes, slot, jobs = [], {}, []
            for b in batches:
                if not b.n[lum]:
                    continue
                remap = []
                for p in b.planes[lum]:
                    if id(p) not in slot:
                        slot[id(p)] = len(planes)
                        planes.append(p)
                    remap.append(slot[id(p)])
                r, *rest = b._jobs(lum)
                jobs.append((np.asarray(remap, dtype=np.int32)[r], *rest))
            cols[lum] = (planes, [np.concatenate(c) for c in zip(*jobs)]) if jobs else None
        if dmesh is not None:
            packed, sizes = mesh_pair(dmesh, cols, bd, dev)
        else:
            args = {lum: None if c is None else
                    (c[0], *upload(c[1][:5], dev), *upload(c[1][5:], dev, dtype=np.bool_))
                    for lum, c in cols.items()}
            packed = to_host(mc_tiles_pair(args[True], args[False], bd)).numpy()
            sizes = {lum: 0 if c is None else len(c[1][0]) for lum, c in cols.items()}
        off = 0
        for lum in (True, False):
            tile = SHAPES[lum][1]
            for b in batches:
                size = b.n[lum] * tile * tile
                if size:
                    b.results[lum] = packed[off:off + size].reshape(-1, tile, tile)
                    off += size
            off += (sizes[lum] - sum(b.n[lum] for b in batches)) * tile * tile


def lane_planes(planes, dev: torch.device) -> list:
    """The reference planes as a lane on `dev` reads them: as they are on
    their own card; else one copy a plane on `dev`, made at first use and
    kept on the plane tensor (a picture's device plane), so that a picture
    crosses to each card once."""
    out = []
    for p in planes:
        if p.device == dev:
            out.append(p)
            continue
        copies = p.__dict__.setdefault("_lane_copies", {})
        if dev not in copies:
            copies[dev] = p.to(dev)
        out.append(copies[dev])
    return out


def mesh_pair(mesh, cols, bd: int, dev: torch.device):
    """Each component class's jobs split over every lane of `mesh`, in its
    gop-major lane order, padded with zero jobs to a multiple of the lane
    count (as pic_shard.split_mc_jobs pads); each lane launches its share on
    its own device into its part of one flat output on `dev` (a lane on
    another card through a copy), fetched in one copy.  cols: {lum: None or
    (planes, [r, x, y, cH, cV, fy, rnd] numpy columns)}.  Returns (the
    fetched flat output, luma first; {lum: padded job count}).  Raises
    ValueError where mesh.check_home refuses the lanes for `dev`."""
    mesh.check_home(dev)
    lanes = mesh.devices
    sizes, parts = {}, []
    for lum, c in cols.items():
        if c is None:
            sizes[lum] = 0
            continue
        planes, job_cols = c
        n = len(job_cols[0])
        share = -(-n // len(lanes))
        sizes[lum] = share * len(lanes)
        padded = []
        for a in job_cols:
            z = np.zeros((sizes[lum],) + a.shape[1:], dtype=a.dtype)
            z[:n] = a
            padded.append(z)
        parts.append((lum, planes, share, padded))
    flat = torch.empty(sum(sizes[lum] * SHAPES[lum][1] ** 2 for lum in sizes),
                       dtype=torch.int32, device=dev)
    pos = 0
    for lum, planes, share, padded in parts:
        taps, tile = SHAPES[lum]
        ints = upload(padded[:5], dev)
        flags = upload(padded[5:], dev, dtype=np.bool_)
        for k, lane in enumerate(lanes):
            jobs = [a[k * share:(k + 1) * share] for a in ints + flags]
            view = flat[pos:pos + share * tile * tile].view(share, tile, tile)
            pos += share * tile * tile
            if lane != dev:
                jobs = [a.to(lane) for a in jobs]
            lp = lane_planes(planes, lane)
            if lane.type == "cuda" and lane == dev:
                mc_tiles_cuda(lp, *jobs, taps=taps, tile=tile, bd=bd, out=view)
            else:
                view.copy_(mc_tiles(lp, *jobs, taps=taps, tile=tile, bd=bd))
    return to_host(flat).numpy(), sizes


class McBatch:
    """Per-slice collector of translational MC tile jobs on one device.

    Usage: add blocks with `add_block` (returns a handle), call `execute()`,
    then read each block back with `block_result`.  Every reference plane
    must be a tensor on the batch's device (a picture's `device_planes`)."""

    def __init__(self, bd: int, device: torch.device | str):
        self.bd = bd
        self.device = torch.device(device)
        # per-block records; tile expansion is vectorised in _jobs()
        self.recs = {True: [], False: []}     # (r, x0, y0, nbx, nby, fy, rnd)
        self.cfs = {True: [], False: []}      # (cf_h, cf_v) per block
        self.planes = {True: [], False: []}   # reference plane tensors
        self.plane_ids = {True: {}, False: {}}
        self.results = {True: None, False: None}
        self.n = {True: 0, False: 0}

    def _plane_idx(self, lum: bool, plane) -> int:
        key = id(plane)
        d = self.plane_ids[lum]
        if key not in d:
            if not torch.is_tensor(plane) or plane.device != self.device:
                where = plane.device if torch.is_tensor(plane) else type(plane).__name__
                raise ValueError(f"McBatch on {self.device} got a reference "
                                 f"plane on {where}")
            d[key] = len(self.planes[lum])
            self.planes[lum].append(plane)
        return d[key]

    def add_block(self, plane, x0, y0, w, h, cf_h, cf_v, frac_y_nz: bool,
                  rnd_res: bool, is_luma: bool):
        """Register one mc_block; (x0, y0) is the sample position of the
        block (integer MV applied); the support offset is applied here."""
        lum = is_luma
        taps, tile = SHAPES[lum]
        half = (taps >> 1) - 1
        r = self._plane_idx(lum, plane)
        nbx, nby = w // tile, h // tile
        self.recs[lum].append((r, x0 - half, y0 - half, nbx, nby,
                               frac_y_nz, rnd_res))
        self.cfs[lum].append((cf_h, cf_v))
        start = self.n[lum]
        self.n[lum] += nbx * nby
        return (lum, start, nby, nbx, tile)

    def execute(self) -> None:
        """Run the collected luma and chroma tiles (one kernel call each)
        and fetch both results in one copy."""
        execute_many([self])

    def _jobs(self, lum: bool):
        """Per-tile (r_idx, x0, y0, cH, cV, fy_nz, rnd) numpy arrays."""
        n = self.n[lum]
        tile = SHAPES[lum][1]
        recs = np.asarray(self.recs[lum], dtype=np.int64)
        r_b, x_b, y_b = recs[:, 0], recs[:, 1], recs[:, 2]
        nbx_b, nby_b = recs[:, 3], recs[:, 4]
        fy_b, rnd_b = recs[:, 5], recs[:, 6]
        counts = nbx_b * nby_b
        blk = np.repeat(np.arange(len(recs)), counts)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        within = np.arange(n) - starts[blk]
        bx = within % nbx_b[blk]
        by = within // nbx_b[blk]
        cfh = np.stack([c[0] for c in self.cfs[lum]]).astype(np.int32)
        cfv = np.stack([c[1] for c in self.cfs[lum]]).astype(np.int32)
        return (r_b[blk].astype(np.int32),
                (x_b[blk] + bx * tile).astype(np.int32),
                (y_b[blk] + by * tile).astype(np.int32),
                cfh[blk], cfv[blk], fy_b[blk].astype(bool),
                rnd_b[blk].astype(bool))

    def block_result(self, handle) -> np.ndarray:
        lum, start, nby, nbx, tile = handle
        r = self.results[lum][start:start + nby * nbx]
        return (
            r.reshape(nby, nbx, tile, tile)
            .transpose(0, 2, 1, 3)
            .reshape(nby * tile, nbx * tile)
            .astype(np.int64)
        )
