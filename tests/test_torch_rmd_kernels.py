"""The port's SATD and batched-RMD kernels against the jax reference.

The same numpy-seeded inputs go through the jax functions of vtm_tpu (jax on
the CPU, as conftest.py forces) and the port's plain torch versions; every
result must be equal (tolerance 0: all of it is int32 arithmetic, and the
SATD's float32 normalisation is jax's).  The CUDA case compares each kernel
with its plain version and runs only on a machine with a CUDA card
(chip_smoke.py makes the same comparison there at 1080p).
"""

import importlib
import importlib.util
import os

import numpy as np
import pytest
import torch

from vtm_tpu.encoder.enc_lib import EncoderConfig
from vtm_tpu.encoder.rmd_tpu import intra_class_list
from vtm_tpu_torch import testing as T
from vtm_tpu_torch.encoder import rmd as RMD
from vtm_tpu_torch.ops import rdcost as RC

SATD_SHAPES = [(2, 2), (4, 4), (8, 8), (16, 16), (8, 16), (16, 8), (4, 8),
               (8, 4), (4, 16), (16, 4), (32, 8), (8, 32), (32, 32), (64, 64)]
PIC_H, PIC_W = 80, 96
CLASSES = intra_class_list(EncoderConfig(width=PIC_W, height=PIC_H))


def _reference(name):
    """A jax reference module (jax on the CPU, as conftest.py forces),
    imported per test so that the CUDA case also runs without jax."""
    if importlib.util.find_spec("jax") is None:
        pytest.skip("the jax reference needs jax")
    return importlib.import_module(name)


@pytest.fixture
def RRC():
    return _reference("vtm_tpu.ops.rdcost")


@pytest.fixture
def RRMD():
    return _reference("vtm_tpu.encoder.rmd_tpu")


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("h,w", SATD_SHAPES)
def test_satd_batch_plain_matches_jax(RRC, h, w):
    import jax.numpy as jnp

    rng = np.random.default_rng(h * 100 + w)
    for bd in (8, 10):
        d = T.satd_diffs(rng, 24, h, w, bd)
        want = np.asarray(RRC.satd_batch_jax(jnp.asarray(d), h, w))
        got = RC.satd_batch_plain(t(d), h, w)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("h,w", [(8, 16), (16, 8), (4, 8), (8, 4)])
def test_satd_float32_normalisation(RRC, h, w):
    """Tiles on which float32 and float64 normalisation differ: the port
    gives jax's float32 integers, not numpy's float64 ones."""
    import jax.numpy as jnp

    d = T.satd_f32_cases(np.random.default_rng(h * 10 + w), h, w, 10)
    assert len(d) >= 5
    want = np.asarray(RRC.satd_batch_jax(jnp.asarray(d), h, w))
    got = RC.satd_batch_plain(t(d), h, w).numpy()
    np.testing.assert_array_equal(got, want)
    f64 = RRC.satd_batch(d, np.zeros_like(d))
    assert (got != f64).all()


def _class_case(RRMD, w, h, bd, src, n, interior=False):
    """(reference (out, red), port (out, red)) of class (w, h) at n seeded
    positions of `src` (interior: with the whole reference row and column
    inside the picture)."""
    rng = np.random.default_rng(w * 64 + h)
    srcpad = np.pad(src, ((1, RMD.PAD_R), (1, RMD.PAD_R)), mode="edge")
    if interior:
        rng = np.random.default_rng(0)
        xs = rng.integers(1, src.shape[1] - 2 * w, n).astype(np.int32)
        ys = rng.integers(1, src.shape[0] - 2 * h, n).astype(np.int32)
    else:
        xs, ys = T.rmd_positions(rng, n, src.shape[1], src.shape[0], w, h)
    fn, consts, mode_order = RRMD.class_fn(w, h, bd, True)
    ref = [np.asarray(a) for a in fn(srcpad, xs, ys, *consts)]
    c = RMD.class_consts(w, h, bd, True, "cpu")
    np.testing.assert_array_equal(c.mode_order, mode_order)
    got = RMD.class_costs_plain(t(srcpad), t(xs), t(ys), c, w, h, bd, True)
    return ref, [g.numpy() for g in got]


@pytest.mark.parametrize("w,h", CLASSES)
def test_class_costs_plain_matches_reference(RRMD, w, h):
    """Every class of the 1080p class list on a seeded 96x80 8-bit source
    (the 64x64 class through the reference's gather form, the others
    through its fp32 matrix form): out and red equal."""
    src = T.rmd_source(np.random.default_rng(7), PIC_H, PIC_W, 8)
    (ref_out, ref_red), (out, red) = _class_case(RRMD, w, h, 8, src, 16)
    np.testing.assert_array_equal(out, ref_out)
    np.testing.assert_array_equal(red, ref_red)


@pytest.mark.parametrize("ramp,w,h", [("diag", 8, 8), ("anti", 4, 16),
                                       ("ver", 4, 16)])
def test_class_costs_plain_ties(RRMD, ramp, w, h):
    """Linear ramps that several modes predict exactly, from references
    inside the picture: the modes tie at cost 0, and the first argmin in
    the native column order [0, 1, 18, 50, ver modes, hor modes] wins, as
    in the reference, where a scan in mode order would pick another mode
    (diagonal ramp, 8x8: modes 66 and 2; anti-diagonal, 4x16: 34 and 33;
    vertical ramp, 4x16: 18, 17 and 19)."""
    yy, xx = np.mgrid[0:PIC_H, 0:PIC_W]
    src = {"diag": 16 + xx + yy, "anti": 100 + xx - yy,
           "ver": 16 + 2 * yy}[ramp].astype(np.int32)
    (ref_out, ref_red), (out, red) = _class_case(RRMD, w, h, 8, src, 6,
                                                 interior=True)
    np.testing.assert_array_equal(out, ref_out)
    np.testing.assert_array_equal(red, ref_red)
    mode_order = RMD.class_consts(w, h, 8, True, "cpu").mode_order
    ang = out[:, :RMD.N_ANG]
    for row, best in zip(ang, red[:, 1]):
        tied = mode_order[row == row.min()]
        assert len(tied) > 1 and row.min() == 0
        assert mode_order[best] != tied.min()


def test_class_costs_plain_10bit(RRMD):
    src = T.rmd_source(np.random.default_rng(8), PIC_H, PIC_W, 10)
    for w, h in ((4, 4), (8, 4), (16, 16), (32, 8)):
        (ref_out, ref_red), (out, red) = _class_case(RRMD, w, h, 10, src, 12)
        np.testing.assert_array_equal(out, ref_out)
        np.testing.assert_array_equal(red, ref_red)


@pytest.mark.parametrize("pattern", ["max", "min", "checker"])
def test_class_costs_plain_10bit_extremes(RRMD, pattern):
    """10-bit sources at the ends of the range: all 1023 (every prediction
    exact), all 0, and a 0 / 1023 checkerboard (the largest differences,
    filter taps and PDPC terms a 10-bit picture gives)."""
    maxv = (1 << 10) - 1
    yy, xx = np.mgrid[0:PIC_H, 0:PIC_W]
    src = {"max": np.full((PIC_H, PIC_W), maxv), "min": np.zeros((PIC_H, PIC_W)),
           "checker": ((yy + xx) & 1) * maxv}[pattern].astype(np.int32)
    for w, h in ((4, 4), (8, 4), (16, 8), (8, 32), (32, 32)):
        (ref_out, ref_red), (out, red) = _class_case(RRMD, w, h, 10, src, 6)
        np.testing.assert_array_equal(out, ref_out)
        np.testing.assert_array_equal(red, ref_red)


def _frame_rmd_pair(RRMD, planes, cfg):
    ref = RRMD.FrameRMD(planes[0], cfg, 1.0)
    got = RMD.FrameRMD(planes[0], cfg, 1.0, device="cpu")
    assert set(got._classes) == set(ref._classes)
    n = 0
    for (w, h), entry in ref._classes.items():
        for (x, y) in entry[0]:
            assert got.stats(x, y, w, h) == ref.stats(x, y, w, h), (x, y, w, h)
            ra, rm = ref.costs(x, y, w, h)
            ga, gm = got.costs(x, y, w, h)
            np.testing.assert_array_equal(ga, ra)
            np.testing.assert_array_equal(gm, rm)
            n += 1
    return got, n


def test_frame_rmd_matches_reference_tiny64(RRMD):
    planes = T.read_source("tiny64_64x64_420_8", 64, 64)
    cfg = EncoderConfig(width=64, height=64, qp=32)
    got, n = _frame_rmd_pair(RRMD, planes, cfg)
    assert n > 1000
    assert got.stats(0, 0, 4, 4)[3] is None  # MIP off


def test_frame_rmd_matches_reference_10bit_mip(RRMD):
    planes = T.read_source("small208_208x120_420_10", 208, 120, bit_depth=10)
    cfg = EncoderConfig(width=208, height=120, qp=32, bit_depth=10, mip=True)
    got, n = _frame_rmd_pair(RRMD, planes, cfg)
    assert got.stats(8, 8, 8, 8)[3] is not None
    # prefetched rows come from the device gather, and equal the full table
    reqs = [(0, 0, 8, 8), (16, 8, 16, 16), (192, 112, 16, 8)]
    got.prefetch_rows(reqs)
    for key in reqs:
        ga, gm = got._rows[key]
        fa, fm = got.costs(*key)
        np.testing.assert_array_equal(ga, fa)
        np.testing.assert_array_equal(gm, fm)


def test_cpu_tensors_take_the_plain_path():
    d = t(T.satd_diffs(np.random.default_rng(1), 3, 8, 8, 8))
    np.testing.assert_array_equal(RC.satd_batch(d, 8, 8).numpy(),
                                  RC.satd_batch_plain(d, 8, 8).numpy())
    src = T.rmd_source(np.random.default_rng(2), 32, 32, 8)
    sp = t(np.pad(src, ((1, RMD.PAD_R), (1, RMD.PAD_R)), mode="edge"))
    xs, ys = (t(a) for a in T.rmd_positions(np.random.default_rng(3), 4, 32, 32, 8, 8))
    c = RMD.class_consts(8, 8, 8, False, "cpu")
    got = RMD.class_costs(sp, xs, ys, c, 8, 8, 8, False)
    want = RMD.class_costs_plain(sp, xs, ys, c, 8, 8, 8, False)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w_.numpy())
    assert (got[1][:, 3] == RMD.NO_MIP).all() and (got[1][:, 4] == 0).all()


def test_dispatch_refuses_other_devices():
    d = torch.zeros((2, 4, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="meta"):
        RC.satd_batch(d, 4, 4)
    c = RMD.class_consts(4, 4, 8, False, "cpu")
    sp = torch.zeros((40, 40), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="meta"):
        RMD.class_costs(sp, sp[0, :2], sp[0, :2], c, 4, 4, 8, False)
    with pytest.raises(ValueError, match="tables of class"):
        RMD.class_costs_plain(torch.zeros((40, 40), dtype=torch.int32),
                              torch.zeros(1, dtype=torch.int32),
                              torch.zeros(1, dtype=torch.int32), c, 8, 8, 8, False)


@pytest.mark.cuda
def test_cuda_kernels_match_plain():
    """Each of the four kernels against its plain version on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    rng = np.random.default_rng(4)
    for h, w in SATD_SHAPES + [(3, 5)]:
        d = T.satd_diffs(rng, 300, h, w, 10)
        got = RC.satd_batch(t(d).to(dev), h, w).cpu()
        np.testing.assert_array_equal(got.numpy(), RC.satd_batch_plain(t(d), h, w).numpy())
    for bd in (8, 10):
        src = T.rmd_source(rng, PIC_H, PIC_W, bd)
        sp = np.pad(src, ((1, RMD.PAD_R), (1, RMD.PAD_R)), mode="edge")
        for w, h in CLASSES:
            xs, ys = T.rmd_positions(rng, 40, PIC_W, PIC_H, w, h)
            for mip in (False, True):
                c_cpu = RMD.class_consts(w, h, bd, mip, "cpu")
                c_dev = RMD.class_consts(w, h, bd, mip, dev)
                want = RMD.class_costs_plain(t(sp), t(xs), t(ys), c_cpu, w, h, bd, mip)
                got = RMD.class_costs(t(sp).to(dev), t(xs).to(dev), t(ys).to(dev),
                                      c_dev, w, h, bd, mip)
                for g, w_ in zip(got, want):
                    np.testing.assert_array_equal(g.cpu().numpy(), w_.numpy())
