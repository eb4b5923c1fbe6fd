"""The multi-device dry run: a real decode's chain inputs and MC batch,
re-run sharded over a mesh of lanes and held to the single-lane results;
then the live decode mesh.

Counterpart of __graft_entry__.py:57-211 (`_capture_real_picture`,
`dryrun_multichip`).  The port's Decoder decodes a golden stream once;
`capture_decode` records each picture's filter-chain inputs and packed
output and the MC tile batches of the decode, by wrapping the chain and MC
entry points of the port's modules for the length of that decode (no
capture flag lives in the decoder).  The wrappers record only the
capturing thread's calls, and one capture runs at a time.  Then
`dryrun_multichip` runs the three sharded functions of
parallel/pic_shard.py and raises unless every lane equals its own
picture's single-lane result.  `live_decode` runs the product decoder
itself under `decode_mesh_ctx` on a mesh (every MC batch split over all
the lanes, the luma chain width-sharded over 'tile') and raises unless
every picture is hashed and every hash matches; the command line runs it
after each dry run, on a mesh of as many lanes.

    python -m vtm_tpu_torch.parallel.multichip [n ...] [--device cpu]
"""

from __future__ import annotations

import os
import sys
import threading
import time

import numpy as np
import torch

from vtm_tpu_torch import kernels as KN
from vtm_tpu_torch.decoder.declib import Decoder
from vtm_tpu_torch.ops import filter_chain as FC
from vtm_tpu_torch.ops import mc_kernel as MK
from vtm_tpu_torch.parallel import pic_shard as PS
from vtm_tpu_torch.parallel.mesh import codec_mesh, decode_mesh_ctx

TESTDATA = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "testdata")
STREAM = "ra_full_small208_qp32"
# the live decode's streams, the first one present (__graft_entry__.py:202)
LIVE_STREAMS = ("ld_min_tiny64_qp32", "ai_min_tiny64_qp27")
# luma MC batches smaller than this are not worth sharding (the reference
# captures the last batch of at least 64 tiles)
MIN_MC_JOBS = 64

_CAPTURES: dict = {}
_CAPTURE_LOCK = threading.Lock()


def read_stream(name: str) -> bytes:
    with open(os.path.join(TESTDATA, f"{name}.bit"), "rb") as f:
        return f.read()


def capture_decode(name: str, device="cuda") -> dict:
    """Decode testdata/<name>.bit with the port's Decoder on `device` (every
    picture hash must match) and record, per picture whose chain runs, its
    chain inputs as host arrays (`planes`, `lmcs_lut`, `dmaps`, `sao_maps`,
    `alf_tables`, `bd`, `sx`, `sy`) and its packed output `out`; and the
    last luma MC batch of at least MIN_MC_JOBS tiles (`mc`: args with the
    planes stacked, taps, tile, bd, and the decode's own result `out`; None
    for a stream without one).

    The chain and MC entry points of ops/filter_chain.py and ops/mc_kernel.py
    are wrapped for the length of the decode: calls from other threads pass
    through unrecorded, and a second capture waits for the first."""
    with _CAPTURE_LOCK:
        return _capture_decode(name, device)


def _capture_decode(name: str, device) -> dict:
    chain, mk_pair = FC.run_filter_chain, MK.mc_tiles_pair
    pics, got = [], {"mc": None}
    owner = threading.get_ident()

    def rec_chain(planes, lmcs_lut, dmaps, sao_maps, alf_tables, bd, sx, sy, dev):
        if threading.get_ident() != owner:
            return chain(planes, lmcs_lut, dmaps, sao_maps, alf_tables, bd, sx, sy, dev)
        pic = dict(planes=[p.copy() for p in planes], lmcs_lut=lmcs_lut,
                   dmaps=dmaps, sao_maps=sao_maps, alf_tables=alf_tables,
                   bd=bd, sx=sx, sy=sy)
        packed = chain(planes, lmcs_lut, dmaps, sao_maps, alf_tables, bd, sx, sy, dev)
        if packed is not None:
            pic["out"] = packed.cpu().numpy()
            pics.append(pic)
        return packed

    def rec_mc(largs, cargs, bd):
        packed = mk_pair(largs, cargs, bd)
        if (threading.get_ident() == owner and largs is not None
                and largs[1].shape[0] >= MIN_MC_JOBS):
            refs, *jobs = largs
            n = jobs[0].shape[0]
            taps, tile = MK.SHAPES[True]
            got["mc"] = dict(
                args=(torch.stack(list(refs)).cpu().numpy(),)
                + tuple(a.cpu().numpy() for a in jobs),
                taps=taps, tile=tile, bd=bd,
                out=packed[:n * tile * tile].reshape(n, tile, tile).cpu().numpy())
        return packed

    FC.run_filter_chain, MK.mc_tiles_pair = rec_chain, rec_mc
    try:
        dec = Decoder(device=device)
        dec.decode_stream(read_stream(name))
        bad = [hr.poc for hr in dec.hash_results if not hr.ok]
        if not dec.hash_results or bad:
            raise AssertionError(f"{name}: hash mismatch at POC {bad}")
    finally:
        FC.run_filter_chain, MK.mc_tiles_pair = chain, mk_pair
    if not pics:
        raise AssertionError(f"{name}: no filter chain ran")
    return dict(pics=pics, mc=got["mc"])


def full_chain_capture(pic: dict) -> dict:
    """One captured picture in the reference's full-chain capture layout
    (pic_shard.run_full_chain_gop's input)."""
    planes = pic["planes"]
    n_comp = len(planes)
    dmaps, sao_maps, alf_tables = pic["dmaps"], pic["sao_maps"], pic["alf_tables"]

    def dmap(m):
        return None if m is None else tuple(getattr(m, f) for f in FC.DMAP_FIELDS)

    return dict(
        y=planes[0], cb=planes[1] if n_comp > 1 else planes[0],
        cr=planes[2] if n_comp > 2 else planes[0],
        lmcs=(None if pic["lmcs_lut"] is None
              else np.asarray(pic["lmcs_lut"], dtype=np.int32)),
        dbv=dmap(dmaps[0]) if dmaps else None,
        dbh=dmap(dmaps[1]) if dmaps else None,
        sao=tuple(sao_maps[c] if sao_maps else None for c in range(3)),
        alf=None if alf_tables is None else tuple(alf_tables["args"]),
        fl=FC.chain_flags(n_comp, pic["lmcs_lut"], dmaps, sao_maps, alf_tables),
        bd=pic["bd"], sx=pic["sx"], sy=pic["sy"], out=pic["out"])


def pick_tile(n: int, width: int) -> int:
    """The reference's tile factor: the largest of 8, 6, 4, 3, 2 that
    divides n and cuts the width into 4-aligned shards at least 8 wide."""
    for t in (8, 6, 4, 3, 2):
        if n % t == 0 and width % (4 * t) == 0 and width // t >= 8:
            return t
    return 1


def timed_runs(fn, repeats: int):
    """fn() run `repeats` times: (the last result, the host seconds of
    each run, the kernel launches of one run as {entry point: count}).
    The runs exist to give the seconds a spread; every run must launch what
    the first one did, so the launches of one run stand for the stage."""
    secs, one = [], None
    for i in range(repeats):
        before = KN.launch_counts()
        t0 = time.perf_counter()
        out = fn()
        secs.append(time.perf_counter() - t0)
        after = KN.launch_counts()
        run = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        if one is None:
            one = run
        elif run != one:
            raise AssertionError(f"run {i + 1} of {repeats} launched {run}, "
                                 f"the first {one}")
    return out, secs, one


def dryrun_multichip(n: int, device="cuda", stream: str = STREAM,
                     tile: int | None = None, cap: dict | None = None,
                     repeats: int = 1) -> dict:
    """Re-run a decode's chain inputs and MC batch sharded over n lanes on
    `device` (lanes share a card when there is one; "cpu" for the tests):
    the width-sharded luma chain over the picture group of the most
    pictures, the MC batch over every lane, and the gop-batched full chain.
    `tile` overrides the reference's tile choice (the rest of the lanes go
    to 'gop').  Raises unless every lane equals its picture's single-lane
    result; returns what ran, with the host seconds of each of the
    `repeats` runs of each stage (inputs uploaded, result fetched), the
    kernel launches of one run of each stage (`stage_launches`: {stage:
    {entry point: count}}) and of one run of every stage (`launches`)."""
    if cap is None:
        key = (stream, str(device))
        if key not in _CAPTURES:
            _CAPTURES[key] = capture_decode(stream, device)
        cap = _CAPTURES[key]
    pics = cap["pics"]
    W = pics[0]["planes"][0].shape[1]
    tile = tile or pick_tile(n, W)
    if n % tile or W % (4 * tile):
        raise ValueError(f"tile {tile} does not fit {n} lanes and width {W}")
    mesh = codec_mesh(n, gop=n // tile, device=device)
    report = dict(n=n, gop=mesh.gop, tile=mesh.tile, stream=stream,
                  devices=sorted({str(d) for d in mesh.devices}))

    # ---- width-sharded luma chain, distinct pictures on 'gop' ----
    args = [PS.luma_chain_args(p) for p in pics]

    def sig(a):
        x, dv, dh, sao, alf, _ = a
        return (x.shape, sao is None, alf is None,
                None if alf is None else (alf[0].shape, alf[1].shape))

    groups: dict = {}
    for a in args:
        groups.setdefault(sig(a), []).append(a)
    group = max(groups.values(), key=len)
    sel = [group[i % len(group)] for i in range(mesh.gop)]
    x, dv, dh, sao, alf, _ = sel[0]
    fn = PS.make_sharded_luma_filters(mesh, sao is not None, alf is not None,
                                      int(pics[0]["bd"]))
    rest = []
    if sao is not None:
        rest.append([np.stack([a[3][i] for a in sel]) for i in range(4)])
    if alf is not None:
        rest.append([np.stack([a[4][i] for a in sel]) for i in range(3)]
                    + list(alf[3:]))
    luma_in = (np.stack([a[0] for a in sel]),
               [np.stack([a[1][i] for a in sel]) for i in range(7)],
               [np.stack([a[2][i] for a in sel]) for i in range(7)], *rest)
    launches: dict = {}
    report["stage_launches"] = {}

    def timed(stage, run):
        out, report[stage], one = timed_runs(run, repeats)
        report["stage_launches"][stage] = one
        for k, v in one.items():
            launches[k] = launches.get(k, 0) + v
        return out

    out = timed("luma_chain_s", lambda: fn(*luma_in).cpu().numpy())
    for b, a in enumerate(sel):
        if not np.array_equal(out[b], a[5]):
            raise AssertionError(f"sharded luma filter chain mismatch "
                                 f"(n={n}, {stream}, lane row {b})")
    report["luma_pictures"] = len(sel)

    # ---- the MC batch over every lane ----
    mc = cap["mc"]
    if mc is not None:
        got = timed("mc_s", lambda: PS.sharded_mc_tiles(mesh, mc).cpu().numpy())
        if not np.array_equal(got, mc["out"]):
            raise AssertionError(f"sharded MC batch mismatch (n={n}, {stream})")
        report["mc_jobs"] = int(mc["out"].shape[0])

    # ---- the full chain, gop-batched ----
    fulls = [full_chain_capture(p) for p in pics]
    fgroups: dict = {}
    for c in fulls:
        fgroups.setdefault(PS.full_chain_sig(c), []).append(c)
    grp = max(fgroups.values(), key=len)

    def full_chain():
        packed, sel_f = PS.run_full_chain_gop(mesh, grp)
        return packed.cpu().numpy(), sel_f

    packed, sel_f = timed("full_chain_s", full_chain)
    for b, c in enumerate(sel_f):
        if not np.array_equal(packed[b], c["out"]):
            raise AssertionError(f"gop-sharded full filter chain mismatch "
                                 f"(n={n}, {stream}, picture {b})")
    report["full_chain_pictures"] = len(sel_f)
    report["launches"] = launches
    return report


def live_decode(mesh, device="cuda", stream: str | None = None) -> dict:
    """The product decoder, Decoder(device), under decode_mesh_ctx(mesh) on
    `stream` (the first of LIVE_STREAMS in testdata/ by default); raises
    unless every picture has a hash and every hash matches.  Returns the
    stream, its pictures' count, the route of each picture's chain
    (mesh.routes) and the decode's host seconds."""
    if stream is None:
        stream = next((s for s in LIVE_STREAMS
                       if os.path.exists(os.path.join(TESTDATA, f"{s}.bit"))), None)
        if stream is None:
            raise FileNotFoundError(f"none of {LIVE_STREAMS} in {TESTDATA}")
    data = read_stream(stream)
    mesh.routes.clear()
    t0 = time.perf_counter()
    with decode_mesh_ctx(mesh):
        dec = Decoder(device=device)
        pics = dec.decode_stream(data)
    secs = time.perf_counter() - t0
    if not pics or len(dec.hash_results) != len(pics):
        raise AssertionError(f"live decode of {stream}: {len(pics)} pictures, "
                             f"{len(dec.hash_results)} hashes")
    bad = [hr.poc for hr in dec.hash_results if not hr.ok]
    if bad:
        raise AssertionError(f"live sharded decode of {stream}: hash mismatch at "
                             f"POC {bad} (n={mesh.size})")
    return dict(stream=stream, pictures=len(pics), routes=list(mesh.routes), seconds=secs)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i:i + 2]
    for n in [int(a) for a in argv] or [2, 8]:
        print(dryrun_multichip(n, device=device), flush=True)
        print(live_decode(codec_mesh(n, device=device), device), flush=True)
    print("MULTICHIP_OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
