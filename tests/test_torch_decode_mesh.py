"""The port's live decode mesh (parallel/mesh.py:decode_mesh_ctx) on the
CPU: Decoder(device="cpu") under a 2 x 2 mesh of CPU lanes, every MC batch
split over the four lanes and the luma chain width-sharded over 'tile'
(tolerance 0).
  - On the three 64x64 streams the reference's live mesh decodes
    (ld_min_tiny64_qp32, ai_min_tiny64_qp27, ai_full_tiny64_qp32), every
    plane equal to the reference's live mesh decode on the 8 virtual CPU
    devices of conftest.py, and every hash matching.
  - On ai_full_small208_qp37, where the reference's live mesh raises (its
    chain binds the mesh's sharding to `sx`, the chroma shift that
    deblocking reads: ROADMAP R1), equal to the port's mesh-off decode and
    hash-exact; the reference's TypeError is pinned too.
  - The context restores the mesh it found; a mesh whose lane (0, 0) is not
    the decoder's device, or with a lane of another device type, raises,
    in the chain's branch and in the MC branch; each MC batch reaches
    every lane.
"""

import os

import numpy as np
import pytest
import torch

from vtm_tpu_torch.decoder.declib import Decoder
from vtm_tpu_torch.ops import mc_kernel as MK
from vtm_tpu_torch.parallel import mesh as M

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["ld_min_tiny64_qp32", "ai_min_tiny64_qp27", "ai_full_tiny64_qp32"]


def stream(name: str) -> bytes:
    with open(os.path.join(ROOT, "testdata", f"{name}.bit"), "rb") as f:
        return f.read()


def port_decode(name: str, mesh=None):
    """(planes of each output picture, hash results) of the port's CPU
    decode, under `mesh` where one is given."""
    dec = Decoder(device="cpu")
    if mesh is None:
        pics = dec.decode_stream(stream(name))
    else:
        with M.decode_mesh_ctx(mesh):
            pics = dec.decode_stream(stream(name))
    return [[np.asarray(p) for p in pic.planes] for pic in pics], dec.hash_results


def ref_live_decode(name: str):
    jax = pytest.importorskip("jax")
    jax.config.update("jax_platforms", "cpu")
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8 virtual CPU devices conftest.py sets up")
    from vtm_tpu.decoder.declib import Decoder as RefDecoder
    from vtm_tpu.parallel import mesh as RM

    with RM.decode_mesh_ctx(RM.codec_mesh(4, gop=2)):
        dec = RefDecoder()
        pics = dec.decode_stream(stream(name))
    return [[np.asarray(p) for p in pic.planes] for pic in pics], dec.hash_results


def cpu_mesh():
    return M.codec_mesh(4, gop=2, device="cpu")


def assert_same(got, want):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert len(a) == len(b)
        for p, q in zip(a, b):
            np.testing.assert_array_equal(p, q)


@pytest.mark.parametrize("name", TINY)
def test_live_mesh_matches_the_reference_live_mesh(name):
    want, ref_hashes = ref_live_decode(name)
    got, hashes = port_decode(name, cpu_mesh())
    assert len(hashes) == len(got) and all(h.ok for h in hashes)
    assert all(h.ok for h in ref_hashes)
    assert_same(got, want)


def test_live_mesh_shards_the_luma_chain_where_the_reference_fails():
    name = "ai_full_small208_qp37"
    mesh = cpu_mesh()
    got, hashes = port_decode(name, mesh)
    assert len(hashes) == len(got) and all(h.ok for h in hashes)
    assert [r["route"] for r in mesh.routes] == ["sharded"] * len(got)
    assert all(r["lanes"] == 2 and r["size"] == (208, 120) for r in mesh.routes)
    assert_same(got, port_decode(name)[0])
    with pytest.raises(TypeError, match="NamedSharding"):
        ref_live_decode(name)


def test_context_restores_the_previous_mesh():
    outer, inner = cpu_mesh(), M.codec_mesh(2, device="cpu")
    assert M.decode_mesh() is None
    with M.decode_mesh_ctx(outer) as got:
        assert got is outer and M.decode_mesh() is outer
        with pytest.raises(RuntimeError):
            with M.decode_mesh_ctx(inner):
                assert M.decode_mesh() is inner
                raise RuntimeError("leave the block")
        assert M.decode_mesh() is outer
    assert M.decode_mesh() is None


def test_home_lane_off_the_decoders_device_raises():
    mesh = cpu_mesh()
    mesh.devices[0] = torch.device("meta")
    with pytest.raises(ValueError, match=r"lane \(0, 0\)"):
        port_decode("ai_full_small208_qp37", mesh)
    assert M.decode_mesh() is None


@pytest.mark.parametrize("lane", [0, 1])
def test_mc_branch_checks_the_mesh(lane):
    """The MC branch checks the mesh itself, as the chain's does: a stream
    whose first pictures run no loop filter reaches MC first.  A lane
    (0, 0) off the batch's device, or any lane of another device type
    ("meta" here, as a CPU lane would be under a decoder on the card),
    raises before a job is split."""
    mesh = cpu_mesh()
    mesh.devices[lane] = torch.device("meta")
    planes = [torch.zeros(16, 16, dtype=torch.int32)]
    cols = {True: (planes, [np.zeros(4, dtype=np.int32)] * 7), False: None}
    with pytest.raises(ValueError, match="decode mesh lane"):
        MK.mesh_pair(mesh, cols, 8, torch.device("cpu"))


def test_each_mc_batch_reaches_every_lane(monkeypatch):
    """Under the mesh every MC batch of an inter decode runs as one call a
    lane a component class, equal shares, zero jobs padding the last."""
    calls = []
    real = MK.mc_tiles

    def count(refs, r_idx, *args, **kw):
        calls.append((kw["taps"], r_idx.shape[0]))
        return real(refs, r_idx, *args, **kw)

    monkeypatch.setattr(MK, "mc_tiles", count)
    got, hashes = port_decode("ld_min_tiny64_qp32", cpu_mesh())
    assert all(h.ok for h in hashes)
    assert calls and len(calls) % 4 == 0
    for i in range(0, len(calls), 4):
        assert len(set(calls[i:i + 4])) == 1


def test_multichip_live_decode():
    """The dry run's live section (multichip.live_decode): the first of its
    streams by default, hash-exact, with each chained picture's route."""
    from vtm_tpu_torch.parallel import multichip as MC

    rep = MC.live_decode(M.codec_mesh(8, device="cpu"), "cpu")
    assert rep["stream"] == "ld_min_tiny64_qp32" and rep["pictures"] == 3
    rep = MC.live_decode(cpu_mesh(), "cpu", stream="ra_full_small208_qp32")
    assert [r["route"] for r in rep["routes"]] == ["sharded", "sharded", "whole"]
    assert M.decode_mesh() is None


def test_lanes_on_another_device_take_copies():
    """What a lane on another card reads, with "meta" standing for that
    card: MC reference planes copied once and kept with the plane (a
    picture crosses once); a neighbour's halo strip copied alone."""
    meta = torch.device("meta")
    planes = [torch.zeros(8, 12, dtype=torch.int32) for _ in range(2)]
    first = MK.lane_planes(planes, meta)
    assert all(p.device == meta and p.shape == (8, 12) for p in first)
    again = MK.lane_planes(planes, meta)
    assert all(a is b for a, b in zip(first, again))
    assert all(a is b for a, b in zip(MK.lane_planes(planes, torch.device("cpu")), planes))
    shard, keep = torch.zeros(8, 12, dtype=torch.int32), []
    _, ld, off = M._source(shard, 1, 12 - 4, 4, meta, keep)
    assert (ld, off) == (4, 0) and keep[0].shape == (8, 4) and keep[0].device == meta
    _, ld, off = M._source(shard, 0, 0, 3, meta, keep)
    assert (ld, off) == (12, 0) and keep[1].shape == (3, 12)
    assert M._source(shard, 1, 8, 4, torch.device("cpu"), keep)[1:] == (12, 8)
