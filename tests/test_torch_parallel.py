"""The port's multi-device path against the jax reference's, on the CPU.

The reference runs on the 8-device virtual CPU mesh that conftest.py gives
jax; the port runs on a mesh of CPU lanes.  The same numpy inputs go to
both, and every sample result must be equal (tolerance 0):
  - `halo_exchange` and `sharded_recon_step` on seeded inputs (the SSE to
    relative 1e-5 against jax's float32 sum, and equal to the exact int64
    sum);
  - the three `pic_shard` functions on the reference's own capture of a
    decode of ra_full_small208_qp32 (`__graft_entry__._capture_real_picture`,
    used read-only), at n = 2, 4 and 8, against jax's sharded output and the
    captured single-device result;
  - the two entries that width sharding adds to the filter kernels
    (`luma_ver_delta` on a shard with a real halo, `sao_apply_ext`);
  - the port's own dry run (`dryrun_multichip(n, device="cpu")`), in this
    process and in one where jax and vtm_tpu cannot be imported, and its
    `timed_runs` (the launches of one run; later runs must match it).
"""

import importlib
import os
import subprocess
import sys
from functools import partial

import numpy as np
import pytest
import torch

from vtm_tpu_torch import testing as TS
from vtm_tpu_torch.ops import deblock_kernel as DK
from vtm_tpu_torch.ops import sao_kernel as SK
from vtm_tpu_torch.ops.filter_chain import to_device
from vtm_tpu_torch.parallel import mesh as M
from vtm_tpu_torch.parallel import multichip as MC
from vtm_tpu_torch.parallel import pic_shard as PS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def jax_or_skip():
    jax = pytest.importorskip("jax")
    jax.config.update("jax_platforms", "cpu")
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8 virtual CPU devices conftest.py sets up")
    return jax


@pytest.fixture(scope="module")
def ref_capture():
    jax_or_skip()
    sys.path.insert(0, ROOT)
    graft = importlib.import_module("__graft_entry__")
    return graft._capture_real_picture()


# ---------------------------------------------------------------------------
# mesh.py


@pytest.mark.parametrize("n,gop", [(4, 1), (8, 2)])
def test_halo_exchange_matches_jax(n, gop):
    jax = jax_or_skip()
    import jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import NamedSharding, PartitionSpec as P

    from vtm_tpu.parallel import mesh as RM

    rows, w, halo = 8, 16, 3
    x = np.random.default_rng(n).integers(-1000, 1000, size=(n * rows, w)).astype(np.int32)
    mesh = RM.codec_mesh(n, gop=1)

    @jax.jit
    @partial(shard_map, mesh=mesh, in_specs=P("tile", None), out_specs=P("tile", None))
    def ext(t):
        return RM.halo_exchange(t, halo, "tile")

    want = np.asarray(ext(jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("tile", None)))))
    shards = list(torch.from_numpy(x).split(rows))
    got = M.halo_exchange(shards, halo)
    assert all(g.shape == (rows + 2 * halo, w) for g in got)
    np.testing.assert_array_equal(torch.cat(got).numpy(), want)


def test_codec_mesh_factors_like_the_reference():
    for n, (gop, tile) in ((1, (1, 1)), (2, (2, 1)), (3, (1, 3)), (4, (2, 2)), (8, (2, 4))):
        mesh = M.codec_mesh(n, device="cpu")
        assert (mesh.gop, mesh.tile) == (gop, tile) and mesh.size == n
    mesh = M.codec_mesh(4, gop=1, device=["cpu"] * 4)
    assert mesh.shape == {"gop": 1, "tile": 4} and mesh.lane(0, 3) == CPU
    with pytest.raises(ValueError):
        M.CodecMesh(["cpu"] * 3, 2, 2)


@pytest.mark.parametrize("n,gop,shape", [(4, 2, (2, 4, 16, 16)), (8, 2, (4, 8, 8, 8)),
                                         (2, 1, (1, 2, 32, 32))])
def test_sharded_recon_step_matches_jax(n, gop, shape):
    jax_or_skip()
    from vtm_tpu.parallel import mesh as RM

    rng = np.random.default_rng(sum(shape))
    coeff = rng.integers(-4096, 4096, size=shape).astype(np.int32)
    coeff[..., 4:, :] = 0
    pred = rng.integers(0, 256, size=shape).astype(np.int32)
    orig = rng.integers(0, 256, size=shape).astype(np.int32)
    want_recon, want_sse = RM.sharded_recon_step(RM.codec_mesh(n, gop=gop), coeff, pred, orig)
    recon, sse = M.sharded_recon_step(M.codec_mesh(n, gop=gop, device="cpu"),
                                      coeff, pred, orig)
    assert recon.dtype == torch.int16 and sse.dtype == torch.float32 and sse.shape == (1,)
    np.testing.assert_array_equal(recon.numpy(), np.asarray(want_recon))
    d = recon.numpy().astype(np.int64) - orig
    assert float(sse[0]) == float(np.float32((d * d).sum()))
    np.testing.assert_allclose(float(sse[0]), float(np.asarray(want_sse)[0]), rtol=1e-5)


# ---------------------------------------------------------------------------
# pic_shard.py on the reference's capture


def _luma_args(cap):
    """The arguments of the sharded luma chain, built from the reference's
    capture as __graft_entry__.dryrun_multichip builds them, for B = the
    capture's pictures of the best picture's signature."""
    pc = cap["pic"]

    def sig(c):
        parts = [c["luma_in"].shape]
        parts += [m.shape for d in (0, 1) for m in c["dmaps"][d]]
        if "sao" in c:
            parts += [m.shape for m in c["sao"]]
        if "alf" in c:
            parts += [c["alf"][k].shape for k in ("cperm", "lperm", "ctu_of")]
        return tuple(parts)

    return pc, [c for c in cap["pics"] if sig(c) == sig(pc)]


def _batched(pc, sel):
    def bat(field):
        return np.stack([np.asarray(field(c)) for c in sel])

    args = [bat(lambda c: c["luma_in"].astype(np.int32)),
            tuple(bat(lambda c, i=i: c["dmaps"][0][i]) for i in range(7)),
            tuple(bat(lambda c, i=i: np.ascontiguousarray(c["dmaps"][1][i].T))
                  for i in range(7))]
    if "sao" in pc:
        args.append(tuple(bat(lambda c, i=i: c["sao"][i]) for i in range(4)))
    if "alf" in pc:
        a = pc["alf"]
        args.append((bat(lambda c: c["alf"]["cperm"]), bat(lambda c: c["alf"]["lperm"]),
                     bat(lambda c: c["alf"]["ctu_of"]), a["o_rows"], a["near"],
                     *a["cls_rows"], *a["cls_blocks"]))
    return args


@pytest.mark.parametrize("n", [2, 4, 8])
def test_sharded_luma_filters_match_jax(ref_capture, n):
    from vtm_tpu.parallel import mesh as RM
    from vtm_tpu.parallel import pic_shard as RPS

    pc, group = _luma_args(ref_capture)
    tile = MC.pick_tile(n, pc["luma_in"].shape[1])
    gop = n // tile
    sel = [group[i % len(group)] for i in range(gop)]
    args = _batched(pc, sel)
    bd = int(pc["bit_depth"])
    have = ("sao" in pc, "alf" in pc)
    want = np.asarray(RPS.make_sharded_luma_filters(RM.codec_mesh(n, gop=gop), *have, bd)(*args))
    got = PS.make_sharded_luma_filters(M.codec_mesh(n, gop=gop, device="cpu"), *have, bd)(*args)
    np.testing.assert_array_equal(got.numpy(), want)
    for b, c in enumerate(sel):
        np.testing.assert_array_equal(got[b].numpy(), c["luma_out"])


@pytest.mark.parametrize("n", [2, 4, 8])
def test_sharded_mc_tiles_match_jax(ref_capture, n):
    from vtm_tpu.parallel import mesh as RM
    from vtm_tpu.parallel import pic_shard as RPS

    mc = ref_capture["mc"]
    assert mc is not None
    want = RPS.sharded_mc_tiles(RM.codec_mesh(n), mc)
    got = PS.sharded_mc_tiles(M.codec_mesh(n, device="cpu"), mc).numpy()
    np.testing.assert_array_equal(got, want)
    # the capture's batch is padded to a bucket; its first n jobs are real
    np.testing.assert_array_equal(got[:mc["n"]], mc["out"])


@pytest.mark.parametrize("n", [2, 4, 8])
def test_full_chain_gop_matches_jax(ref_capture, n):
    from vtm_tpu.parallel import mesh as RM
    from vtm_tpu.parallel import pic_shard as RPS

    fulls = [c["full"] for c in ref_capture["pics"] if "full" in c]
    groups = {}
    for c in fulls:
        groups.setdefault(RPS.full_chain_sig(c), []).append(c)
    grp = max(groups.values(), key=len)
    assert PS.full_chain_sig(grp[0]) == RPS.full_chain_sig(grp[0])
    want, want_sel = RPS.run_full_chain_gop(RM.codec_mesh(n), grp)
    got, sel = PS.run_full_chain_gop(M.codec_mesh(n, device="cpu"), grp)
    assert [id(c) for c in sel] == [id(c) for c in want_sel]
    np.testing.assert_array_equal(got.numpy(), want)
    for b, c in enumerate(sel):
        np.testing.assert_array_equal(got[b].numpy(), c["out"])


# ---------------------------------------------------------------------------
# the two entries width sharding adds to the filter kernels


@pytest.mark.parametrize("bd", [8, 10])
def test_luma_ver_delta_on_a_halo_shard(bd):
    """Deltas of a shard whose 8-column halo holds its neighbours' samples
    (not edge copies), equal to jax's; the deltas that reach the halo are
    what the neighbours get back."""
    import jax.numpy as jnp

    from vtm_tpu.ops import deblock_kernel as RDK

    rng = np.random.default_rng(bd)
    h, w = 64, 96
    plane = TS.plane(rng, h, w + 16, bd)
    maps = TS.deblock_maps(rng, h, w, bd, False)[:7]
    want = np.asarray(RDK.luma_ver_delta(jnp.asarray(plane),
                                         *(jnp.asarray(m) for m in maps), bd))
    got = DK.luma_ver_delta(to_device(plane, CPU), *(to_device(m, CPU) for m in maps), bd)
    np.testing.assert_array_equal(got.numpy(), want)
    # the edges at column 0 write into the left halo: the left neighbour's part
    assert np.abs(want[:, :8]).sum()


@pytest.mark.parametrize("bd", [8, 10])
def test_sao_apply_ext_on_a_halo_shard(bd):
    import jax.numpy as jnp

    from vtm_tpu.ops import sao_kernel as RSK

    rng = np.random.default_rng(bd + 1)
    h, w = 48, 80
    pad = TS.plane(rng, h + 2, w + 2, bd)
    maps = TS.sao_maps(rng, h, w, 6, bd)
    want = np.asarray(RSK.sao_apply_ext(*(jnp.asarray(a) for a in (pad, *maps)), bd))
    got = SK.sao_apply_ext(to_device(pad, CPU), *(to_device(m, CPU) for m in maps), bd)
    np.testing.assert_array_equal(got.numpy(), want)
    # sao_apply is the extended form on the edge-replicated plane
    core = pad[1:-1, 1:-1].copy()
    np.testing.assert_array_equal(
        SK.sao_apply(to_device(core, CPU), *(to_device(m, CPU) for m in maps), bd).numpy(),
        np.asarray(RSK.sao_apply(core, *maps, bit_depth=bd)))


# ---------------------------------------------------------------------------
# the port's own dry run


@pytest.mark.parametrize("n", [2, 8])
def test_dryrun_multichip_cpu(n):
    rep = MC.dryrun_multichip(n, device="cpu")
    assert rep["gop"] * rep["tile"] == n and rep["devices"] == ["cpu"]
    assert rep["luma_pictures"] == rep["gop"] and rep["mc_jobs"] >= MC.MIN_MC_JOBS
    assert rep["full_chain_pictures"] >= rep["gop"]
    assert rep["launches"] == {}  # CPU lanes take the plain versions


def test_timed_runs_counts_one_run(monkeypatch):
    """timed_runs returns the launches of one run, and refuses runs that
    launch other kernels or other counts than the first."""
    from vtm_tpu_torch import kernels as KN

    monkeypatch.setattr(KN, "_launches", dict.fromkeys(KN.KERNELS, 0))
    runs = iter([2, 2, 2, 3])

    def stage(n):
        KN._launches["vtm_alf_classify"] += n
        KN._launches["vtm_mc_tiles"] += 1
        return n

    out, secs, one = MC.timed_runs(lambda: stage(next(runs)), 3)
    assert out == 2 and len(secs) == 3
    assert one == {"vtm_alf_classify": 2, "vtm_mc_tiles": 1}
    assert KN.launch_counts()["vtm_alf_classify"] == 6
    runs = iter([2, 3])
    with pytest.raises(AssertionError, match="run 2 of 2"):
        MC.timed_runs(lambda: stage(next(runs)), 2)


def test_capture_records_only_its_own_thread():
    """A decode in another thread while a capture runs passes through its
    wrappers unrecorded, and decodes hash-exact."""
    import threading

    from vtm_tpu_torch.decoder.declib import Decoder
    from vtm_tpu_torch.ops import filter_chain as FC

    chain = FC.run_filter_chain
    got = {}
    t = threading.Thread(target=lambda: got.update(
        cap=MC.capture_decode("ra_full_bq416_qp37", "cpu")))
    t.start()
    while FC.run_filter_chain is chain and t.is_alive():
        pass
    dec = Decoder(device="cpu")
    pics = dec.decode_stream(MC.read_stream("ai_full_tiny64_qp32"))
    overlapped = FC.run_filter_chain is not chain
    t.join()
    assert overlapped, "the other decode ended after the capture"
    assert pics and all(hr.ok for hr in dec.hash_results)
    assert FC.run_filter_chain is chain
    alone = MC.capture_decode("ra_full_bq416_qp37", "cpu")
    assert len(got["cap"]["pics"]) == len(alone["pics"])
    for p, q in zip(got["cap"]["pics"], alone["pics"]):
        np.testing.assert_array_equal(p["out"], q["out"])
    np.testing.assert_array_equal(got["cap"]["mc"]["out"], alone["mc"]["out"])


def test_dryrun_without_jax_or_vtm_tpu():
    """The dry run needs neither jax nor the reference package."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['vtm_tpu'] = None\n"
        "from vtm_tpu_torch.parallel import multichip as MC\n"
        "rep = MC.dryrun_multichip(4, device='cpu')\n"
        "assert rep['tile'] == 4, rep\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'vtm_tpu')"
        " and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


@pytest.mark.cuda
def test_cuda_entries_match_plain():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    for bd in (8, 10):
        h, w = 1080, 240
        plane = to_device(TS.plane(rng, h, w + 16, bd), dev)
        maps = [to_device(m, dev) for m in TS.deblock_maps(rng, h, w, bd, False)[:7]]
        assert torch.equal(DK.luma_ver_delta_cuda(plane, *maps, bd),
                           DK.luma_ver_delta_plain(plane, *maps, bd))
        pad = to_device(TS.plane(rng, h + 2, w + 2, bd), dev)
        smaps = [to_device(m, dev) for m in TS.sao_maps(rng, h, w, 30, bd)]
        assert torch.equal(SK.sao_apply_ext_cuda(pad, *smaps, bd),
                           SK.sao_apply_ext_plain(pad, *smaps, bd))
        resid = torch.from_numpy(rng.integers(-300, 300, (64, 8, 8)).astype(np.int32)).to(dev)
        pred, orig = (torch.from_numpy(rng.integers(0, 256, (64, 8, 8)).astype(np.int32)).to(dev)
                      for _ in range(2))
        r1, s1 = M.recon_sse_cuda(resid, pred, orig)
        r2, s2 = M.recon_sse_plain(resid, pred, orig)
        assert torch.equal(r1, r2) and torch.equal(s1, s2)
    for n in (2, 8):
        MC.dryrun_multichip(n, device="cuda")
