"""The port's MC, DMVR, FIR and BDOF kernels against the jax reference.

The same inputs go through the jitted vtm_tpu function (jax on the CPU, as
conftest.py forces) and the port's plain torch version; every result must
be equal (tolerance 0: all of it is int32 arithmetic).  Two kinds of input:
numpy-seeded cases (vtm_tpu_torch.testing) and the real inputs of every
call a reference decode of ra_full_small208_qp32 makes.  The CUDA case
compares each kernel with its plain version and runs only on a machine with
a CUDA card (chip_smoke.py makes the same comparison there).
"""

import importlib
import importlib.util
import os

import numpy as np
import pytest
import torch

from vtm_tpu.ops import mc as MC
from vtm_tpu_torch import testing as T
from vtm_tpu_torch.ops import mc_kernel as MK
from vtm_tpu_torch.ops import refine_kernel as RK
from vtm_tpu_torch.ops.filter_chain import to_device

CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECORDED_STREAM = "ra_full_small208_qp32"


def t(a):
    return to_device(a, CPU)


def _reference(name):
    """A jax reference module, imported per test so that the CUDA case also
    runs on a machine without jax."""
    if importlib.util.find_spec("jax") is None:
        pytest.skip("the jax reference needs jax")
    return importlib.import_module(f"vtm_tpu.ops.{name}")


@pytest.fixture
def RMK():
    return _reference("mc_kernel")


@pytest.fixture
def RRK():
    return _reference("refine_kernel")


def assert_same(ref, got):
    """jax result vs torch result: equal values and shapes, int32."""
    assert got.dtype == torch.int32, got.dtype
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# ---------------------------------------------------------------------------
# numpy-seeded cases

@pytest.mark.parametrize("lum", [True, False], ids=["luma", "chroma"])
@pytest.mark.parametrize("bd", [8, 10])
def test_mc_tiles(RMK, bd, lum):
    rng = np.random.default_rng(21)
    h, w = (40, 56) if lum else (20, 28)
    refs = np.stack([T.plane(rng, h, w, bd) for _ in range(3)])
    args = T.mc_tiles_case(rng, refs, 400, lum, bd)
    taps, tile = MK.SHAPES[lum]
    r_idx, x0, y0, _, _, fy_nz, rnd = args
    span = tile + taps - 1
    # windows off every edge; uni and bi; both final-stage forms
    assert (x0 < 0).any() and (x0 + span > w).any()
    assert (y0 < 0).any() and (y0 + span > h).any()
    assert rnd.any() and (~rnd).any() and fy_nz.any() and (~fy_nz).any()
    ref = RMK.mc_tiles(refs, *args, taps=taps, tile=tile, bd=bd)
    got = MK.mc_tiles(list(t(refs)), *map(t, args), taps=taps, tile=tile, bd=bd)
    assert_same(ref, got)


@pytest.mark.parametrize("dx,dy", [(8, 8), (8, 16), (16, 8), (16, 16)])
def test_dmvr_search(RRK, dx, dy):
    rng = np.random.default_rng(22)
    for bd in (8, 10):
        args = T.dmvr_case(rng, 64, dx, dy, bd)
        ref = np.asarray(RRK.dmvr_search(*args, bd=bd, dx=dx, dy=dy))
        got = RK.dmvr_search(*map(t, args), bd=bd, dx=dx, dy=dy)
        assert_same(ref, got)
        scale = 4 if bd == 8 else 1
        # the crafted cases: the centre wins its tie with the dmy = -1 row
        # (edge case of the sub-pel surface: -8 in y); with the row below
        # the bias the first of five tied offsets, (-2, -1), wins; the
        # flat pair terminates early with cost 0
        np.testing.assert_array_equal(
            ref[:, :3], [[0, -32, 0], [-8, -16, 0],
                         [scale * 75 * dx * dy // 2, scale * 50 * dx * dy // 2, 0]])
        assert len({tuple(c) for c in ref[:2, 3:].T}) > 5, "too few search outcomes"


@pytest.mark.parametrize("taps,w,h", [(8, 16, 16), (8, 8, 16), (4, 8, 8), (4, 4, 8)])
def test_fir_blocks(RRK, taps, w, h):
    rng = np.random.default_rng(23)
    for bd in (8, 10):
        args = T.fir_blocks_case(rng, 48, taps, w, h, bd)
        ref = RRK.fir_blocks(*args, w=w, h=h, taps=taps, bd=bd)
        got = RK.fir_blocks(*map(t, args), w=w, h=h, taps=taps, bd=bd)
        assert_same(ref, got)


def test_dmvr_final_pack(RRK):
    rng = np.random.default_rng(24)
    l0, l1 = (T.fir_blocks_case(rng, 16, 8, 16, 8, 8) for _ in range(2))
    cargs = tuple(T.fir_blocks_case(rng, 16, 4, 8, 4, 8) for _ in range(4))
    kw = dict(w=16, h=8, wc=8, hc=4, bd=8)
    ref = RRK.dmvr_final_pack(l0, l1, cargs, nc=len(cargs), **kw)
    got = RK.dmvr_final_pack(tuple(map(t, l0)), tuple(map(t, l1)),
                             tuple(tuple(map(t, a)) for a in cargs), **kw)
    assert_same(ref, got)


@pytest.mark.parametrize("w,h", [(8, 8), (16, 16), (8, 16)])
def test_bdof_blend_batch(RRK, w, h):
    rng = np.random.default_rng(25)
    for bd in (8, 10):
        p0e, p1e = T.bdof_case(rng, 64, w, h, bd)
        ref = np.asarray(RRK.bdof_blend_batch(p0e, p1e, bd=bd, w=w, h=h))
        got = RK.bdof_blend_batch(t(p0e), t(p1e), bd=bd, w=w, h=h)
        assert_same(ref, got)
        assert ref.min() == 0 and ref.max() == (1 << bd) - 1  # both clips hit


# ---------------------------------------------------------------------------
# real inputs, recorded during a reference decode

@pytest.fixture(scope="module")
def recorded():
    """Arguments and results of every MC, DMVR-search, final-pack and BDOF
    call of a reference decode (module attributes wrapped for the decode
    only; nothing in vtm_tpu changes)."""
    RMK = _reference("mc_kernel")
    RRK = _reference("refine_kernel")
    from vtm_tpu.decoder.declib import Decoder

    got = {}
    patches = [(RMK, "_mc_tiles_pair"), (RRK, "dmvr_search"),
               (RRK, "dmvr_final_pack"), (RRK, "bdof_blend_batch")]
    reals = [getattr(m, n) for m, n in patches]

    def host(a):
        if a is None:
            return None
        if isinstance(a, tuple):
            return tuple(host(x) for x in a)
        return np.asarray(a)

    def recorder(name, real):
        def call(*args, **kw):
            out = real(*args, **kw)
            got.setdefault(name, []).append((host(args), kw, np.asarray(out)))
            return out
        return call

    for (mod, name), real in zip(patches, reals):
        setattr(mod, name, recorder(name, real))
    try:
        with open(os.path.join(ROOT, "testdata", f"{RECORDED_STREAM}.bit"), "rb") as f:
            dec = Decoder()
            dec.decode_stream(f.read())
    finally:
        for (mod, name), real in zip(patches, reals):
            setattr(mod, name, real)
    assert all(hr.ok for hr in dec.hash_results)
    return got


def test_recorded_mc_tiles_pair(recorded):
    calls = recorded["_mc_tiles_pair"]
    assert calls
    for (largs, cargs, *_), kw, out in calls:
        def tt(a):
            return None if a is None else (list(t(a[0])),) + tuple(map(t, a[1:]))
        assert_same(out, MK.mc_tiles_pair(tt(largs), tt(cargs), **kw))


def test_recorded_dmvr_search(recorded):
    calls = recorded["dmvr_search"]
    assert calls
    for args, kw, out in calls:
        assert_same(out, RK.dmvr_search(*map(t, args), **kw))


def test_recorded_dmvr_final_pack(recorded):
    calls = recorded["dmvr_final_pack"]
    assert calls
    for (l0, l1, cargs), kw, out in calls:
        kw = {k: v for k, v in kw.items() if k != "nc"}
        got = RK.dmvr_final_pack(tuple(map(t, l0)), tuple(map(t, l1)),
                                 tuple(tuple(map(t, a)) for a in cargs), **kw)
        assert_same(out, got)


def test_recorded_bdof_blend_batch(recorded):
    calls = recorded["bdof_blend_batch"]
    assert calls
    for args, kw, out in calls:
        assert_same(out, RK.bdof_blend_batch(*map(t, args), **kw))


# ---------------------------------------------------------------------------
# the batch

def _blocks(rng, h, w):
    """Mixed-size blocks (w, h, x, y, frac_x, frac_y, rnd) on a h x w plane."""
    out = []
    for bw, bh in ((4, 4), (8, 4), (4, 16), (16, 8), (32, 32), (8, 8), (64, 16)):
        out.append((bw, bh, int(rng.integers(-20, w)), int(rng.integers(-20, h)),
                    int(rng.integers(0, 16)), int(rng.integers(0, 16)),
                    bool(rng.integers(0, 2))))
    return out


def _fill(batch, planes, blocks):
    handles = []
    for k, (bw, bh, x, y, fx, fy, rnd) in enumerate(blocks):
        for lum in (True, False):
            plane = planes[lum][k % len(planes[lum])]
            if lum:
                cfh = MC.luma_coeffs(fx, bw, bh if fy == 0 else bh + 7, False, True)
                cfv = MC.luma_coeffs(fy, bw, bh, False, False)
                args = (x, y, bw, bh, cfh, cfv, fy != 0)
            else:
                args = (x >> 1, y >> 1, bw >> 1, bh >> 1, MC._CHROMA[fx * 2],
                        MC._CHROMA[fy * 2], fy != 0)
            handles.append(batch.add_block(plane, *args, rnd, lum))
    return handles


def test_mc_batch_round_trips_mixed_blocks(RMK):
    """Each block_result of the port's McBatch equals the reference
    McBatch's and the scalar mc_block's; two batches run through
    execute_many give what each gives alone."""
    rng = np.random.default_rng(26)
    bd = 8
    planes = {True: [T.plane(rng, 64, 96, bd) for _ in range(2)],
              False: [T.plane(rng, 32, 48, bd) for _ in range(2)]}
    tplanes = {k: [t(p) for p in v] for k, v in planes.items()}
    blocks = _blocks(rng, 64, 96)
    ref = RMK.McBatch(bd)
    href = _fill(ref, planes, blocks)
    ref.execute()
    port = MK.McBatch(bd, CPU)
    hport = _fill(port, tplanes, blocks)
    port.execute()
    for a, b in zip(href, hport):
        np.testing.assert_array_equal(port.block_result(b), ref.block_result(a))
    bw, bh, x, y, fx, fy, rnd = blocks[4]
    want = MC.mc_block(planes[True][0], x, y, bw, bh, fx, fy, True, bd, rnd_res=rnd)
    np.testing.assert_array_equal(port.block_result(hport[8]), want)
    # execute_many: the same blocks split over two batches, one call
    first, second = MK.McBatch(bd, CPU), MK.McBatch(bd, CPU)
    h1 = _fill(first, tplanes, blocks[:3])
    h2 = _fill(second, {True: tplanes[True][::-1], False: tplanes[False]}, blocks[3:])
    MK.execute_many([first, second])
    alone = MK.McBatch(bd, CPU)
    h2_alone = _fill(alone, {True: tplanes[True][::-1], False: tplanes[False]},
                     blocks[3:])
    alone.execute()
    for a, b in zip(h1, hport[:6]):
        np.testing.assert_array_equal(first.block_result(a), port.block_result(b))
    for a, b in zip(h2, h2_alone):
        np.testing.assert_array_equal(second.block_result(a), alone.block_result(b))


def test_cpu_wrappers_take_the_plain_path():
    """A CPU tensor never reaches the kernel library."""
    from vtm_tpu_torch import kernels as KN

    rng = np.random.default_rng(27)
    before = KN.launch_counts()
    p0e, p1e = T.bdof_case(rng, 4, 8, 8, 8)
    RK.bdof_blend_batch(t(p0e), t(p1e), bd=8, w=8, h=8)
    RK.dmvr_search(*map(t, T.dmvr_case(rng, 4, 8, 8, 8)), bd=8, dx=8, dy=8)
    assert KN.launch_counts() == before


def test_dispatch_refuses_other_devices():
    meta = torch.empty((2, 10, 10), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="meta"):
        RK.bdof_blend_batch(meta, meta, bd=8, w=8, h=8)


# ---------------------------------------------------------------------------
# on the card

@pytest.mark.cuda
def test_cuda_kernels_match_plain():
    """Each new CUDA kernel equals its plain version on seeded cases."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    dev = torch.device("cuda")
    rng = np.random.default_rng(28)

    def d(a):
        return to_device(a, dev)

    for bd in (8, 10):
        for lum in (True, False):
            h, w = (64, 96) if lum else (32, 48)
            refs = np.stack([T.plane(rng, h, w, bd) for _ in range(3)])
            args = T.mc_tiles_case(rng, refs, 2000, lum, bd)
            taps, tile = MK.SHAPES[lum]
            drefs = list(d(refs))
            assert torch.equal(
                MK.mc_tiles(drefs, *map(d, args), taps=taps, tile=tile, bd=bd),
                MK.mc_tiles_plain(drefs, *map(d, args), taps=taps, tile=tile, bd=bd))
        for dx, dy in ((8, 8), (8, 16), (16, 8), (16, 16)):
            args = [d(a) for a in T.dmvr_case(rng, 200, dx, dy, bd)]
            assert torch.equal(RK.dmvr_search(*args, bd=bd, dx=dx, dy=dy),
                               RK.dmvr_search_plain(*args, bd=bd, dx=dx, dy=dy))
            p = [d(a) for a in T.bdof_case(rng, 200, dx, dy, bd)]
            assert torch.equal(RK.bdof_blend_batch(*p, bd=bd, w=dx, h=dy),
                               RK.bdof_blend_batch_plain(*p, bd=bd, w=dx, h=dy))
        for taps in (8, 4):
            args = [d(a) for a in T.fir_blocks_case(rng, 200, taps, 16, 8, bd)]
            assert torch.equal(
                RK.fir_blocks(*args, w=16, h=8, taps=taps, bd=bd),
                RK.fir_blocks_plain(*args, w=16, h=8, taps=taps, bd=bd))
