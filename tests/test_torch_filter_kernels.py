"""The port's in-loop filter kernels against the jax reference.

The same numpy-seeded inputs go through the jitted vtm_tpu function (jax on
the CPU, as conftest.py forces) and the port's plain torch version; every
result must be equal (tolerance 0: all of it is int32 arithmetic).  The
CUDA case compares each kernel with its plain version and runs only on a
machine with a CUDA card (chip_smoke.py makes the same comparison there).
"""

import importlib
import importlib.util

import numpy as np
import pytest
import torch

from vtm_tpu_torch import testing as T
from vtm_tpu_torch.ops import alf_kernel as AK
from vtm_tpu_torch.ops import deblock_kernel as DK
from vtm_tpu_torch.ops import sao_kernel as SK
from vtm_tpu_torch.ops.filter_chain import to_device

CPU = torch.device("cpu")
H, W = 64, 128
CTU = 32  # VB rows at 28, 32 (chroma 12, 16 in 4:2:0) fall inside the picture


def t(a):
    return to_device(a, CPU)


def _reference(name):
    """A jax reference module (jax on the CPU, as conftest.py forces),
    imported per test so that the CUDA case also runs on the GPU machine,
    which has no jax."""
    if importlib.util.find_spec("jax") is None:
        pytest.skip("the jax reference needs jax")
    return importlib.import_module(f"vtm_tpu.ops.{name}")


@pytest.fixture
def RDK():
    return _reference("deblock_kernel")


@pytest.fixture
def RSK():
    return _reference("sao_kernel")


@pytest.fixture
def RAK():
    return _reference("alf_kernel")


def assert_same(ref, got):
    """jax result(s) vs torch result(s): equal values, shapes and int32."""
    if isinstance(ref, (tuple, list)):
        assert len(ref) == len(got)
        for r, g in zip(ref, got):
            assert_same(r, g)
        return
    ref = np.asarray(ref)
    assert got.dtype in (torch.int32, torch.bool), got.dtype
    np.testing.assert_array_equal(got.numpy(), ref)


DEBLOCK_CASES = [("420", 8, False), ("420", 8, True), ("422", 8, False),
                 ("422", 8, True), ("444", 10, False), ("444", 10, True),
                 ("420", 10, True)]


@pytest.mark.parametrize("fmt,bd,hor", DEBLOCK_CASES)
def test_deblock_dir(RDK, fmt, bd, hor):
    rng = np.random.default_rng(11)
    sx, sy = T.FORMATS[fmt]
    y, cb, cr = T.planes(rng, H, W, fmt, bd)
    maps = T.deblock_maps(rng, H, W, bd, hor)
    kw = dict(bit_depth=bd, hor=hor, has_l=True, has_cb=True, has_cr=True,
              sx=sx, sy=sy)
    ref = RDK.deblock_dir(y, cb, cr, *maps, **kw)
    got = DK.deblock_dir(t(y), t(cb), t(cr), *map(t, maps), **kw)
    assert_same(ref, got)
    assert not np.array_equal(np.asarray(ref[0]), y), "no luma edge was filtered"


@pytest.mark.parametrize("bd", [8, 10])
def test_deblock_luma_ver(RDK, bd):
    """The single-component wrapper: pad + luma_ver_delta on the CPU."""
    rng = np.random.default_rng(21)
    plane = T.plane(rng, H, W, bd)
    maps = T.deblock_maps(rng, H, W, bd, False)[:7]
    ref = RDK.deblock_luma_ver(plane, *maps, bit_depth=bd)
    got = DK.deblock_luma_ver(t(plane), *map(t, maps), bit_depth=bd)
    assert_same(ref, got)
    assert not np.array_equal(got.numpy(), plane), "no edge was filtered"


@pytest.mark.parametrize("bd,loop_len,dec_line", [(8, 2, 1), (10, 4, 3)])
def test_deblock_chroma_ver(RDK, bd, loop_len, dec_line):
    """The single-component wrapper, maps on the chroma segment grid (the
    one of subsampled and of full-resolution chroma)."""
    rng = np.random.default_rng(22)
    hc, wc = H // 2, W // 2
    plane = T.plane(rng, hc, wc, bd)
    # the luma-grid maps of a plane twice the size, one segment per
    # (loop_len rows, 4 columns)
    full = T.deblock_maps(rng, hc // loop_len * 4, wc, bd, False)
    maps = tuple(np.ascontiguousarray(m) for m in full[7:10] + full[13:17])
    assert maps[0].shape == (hc // loop_len, wc // 4)
    kw = dict(bit_depth=bd, loop_len=loop_len, dec_line=dec_line)
    ref = RDK.deblock_chroma_ver(plane, *maps, **kw)
    got = DK.deblock_chroma_ver(t(plane), *map(t, maps), **kw)
    assert_same(ref, got)
    assert not np.array_equal(got.numpy(), plane), "no edge was filtered"


@pytest.mark.parametrize("bd", [8, 10])
def test_sao_apply(RSK, bd):
    rng = np.random.default_rng(12)
    src = T.plane(rng, H, W, bd)
    maps = T.sao_maps(rng, H, W, 8, bd)
    ref = RSK.sao_apply(src, *maps, bit_depth=bd)
    got = SK.sao_apply(t(src), *map(t, maps), bit_depth=bd)
    assert_same(ref, got)


def _luma_tables(rng, bd, fmt="420"):
    return T.alf_tables(rng, H, W, fmt, bd, CTU)


@pytest.mark.parametrize("bd", [8, 10])
def test_classify_picture(RAK, bd):
    rng = np.random.default_rng(13)
    pad = np.pad(T.plane(rng, H, W, bd), AK.PAD, mode="edge")
    rows = _luma_tables(rng, bd)[5:12]
    ref = RAK.classify_picture(pad, *rows, bit_depth=bd)
    got = AK.classify_picture(t(pad), *map(t, rows), bit_depth=bd)
    assert_same(ref, got)
    assert len(np.unique(np.asarray(ref[0]))) > 3


def _coef_maps(rng, h, w, n, bd):
    coef = rng.integers(-64, 65, size=(h // 4, w // 4, n)).astype(np.int32)
    clip = rng.integers(0, 1 << bd, size=(h // 4, w // 4, n)).astype(np.int32)
    return coef, clip


@pytest.mark.parametrize("luma,bd", [(True, 8), (True, 10), (False, 8), (False, 10)])
def test_alf_filter(RAK, luma, bd):
    rng = np.random.default_rng(14)
    h, w = (H, W) if luma else (H // 2, W // 2)
    ctu = CTU if luma else CTU // 2
    src = T.plane(rng, h, w, bd)
    coef, clip = _coef_maps(rng, h, w, 12 if luma else 6, bd)
    coef[:4] = 0  # an ALF-off CTU row: identity there
    o_rows, near = AK.vb_row_offsets(h, ctu, ctu - (4 if luma else 2), luma)
    taps = AK.LUMA_TAPS if luma else AK.CHROMA_TAPS
    pad = np.pad(src, AK.PAD, mode="edge")
    ref = RAK.alf_filter(pad, coef, clip, o_rows, near, taps=taps, bit_depth=bd)
    got = AK.alf_filter(t(pad), t(coef), t(clip), t(o_rows), t(near), taps=taps,
                        bit_depth=bd)
    assert_same(ref, got)
    np.testing.assert_array_equal(got.numpy()[:16], src[:16])
    assert near.any() and not np.array_equal(got.numpy(), src)


@pytest.mark.parametrize("fmt", ["420", "422", "444"])
def test_ccalf_filter(RAK, fmt):
    rng = np.random.default_rng(15)
    bd = 10 if fmt == "444" else 8
    sx, sy = T.FORMATS[fmt]
    y, cb, _ = T.planes(rng, H, W, fmt, bd)
    hc, wc = cb.shape
    coef = rng.integers(-32, 33, size=(hc // 4, wc // 4, 7)).astype(np.int32)
    o_rows, skip = AK.ccalf_row_offsets(hc, sy, CTU, CTU - 4)
    y_pad = np.pad(y, AK.PAD, mode="edge")
    kw = dict(scale_x=sx, scale_y=sy, bit_depth=bd)
    ref = RAK.ccalf_filter(y_pad, cb, coef, o_rows, skip, **kw)
    got = AK.ccalf_filter(t(y_pad), t(cb), t(coef), t(o_rows), t(skip), **kw)
    assert_same(ref, got)


@pytest.mark.parametrize("fmt,bd", [("420", 8), ("422", 8), ("444", 10)])
def test_alf_all(RAK, fmt, bd):
    rng = np.random.default_rng(16)
    sx, sy = T.FORMATS[fmt]
    y, cb, cr = T.planes(rng, H, W, fmt, bd)
    args = _luma_tables(rng, bd, fmt)
    y_pad = np.pad(y, AK.PAD, mode="edge")
    kw = dict(bit_depth=bd, sx=sx, sy=sy, has_l=True, has_cb=True, has_cr=True,
              has_cc1=True, has_cc2=True)
    ref = RAK.alf_all(y_pad, cb, cr, *args, **kw)
    got = AK.alf_all(t(y_pad), t(cb), t(cr), *map(t, args), **kw)
    assert_same(ref, got)


def test_row_helpers_match_reference(RAK):
    """The port's numpy copies of the VB row tables equal the reference's."""
    for h, ctu in ((64, 32), (120, 64), (1080, 128)):
        for a, b in zip(AK.vb_row_offsets(h, ctu, ctu - 4, True),
                        RAK.vb_row_offsets(h, ctu, ctu - 4, True)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(AK.classify_row_indices(h, ctu, ctu - 4),
                        RAK.classify_row_indices(h, ctu, ctu - 4)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(AK.classify_block_rows(h, ctu, ctu - 4),
                        RAK.classify_block_rows(h, ctu, ctu - 4)):
            np.testing.assert_array_equal(a, b)
        for sy in (0, 1):
            for a, b in zip(AK.ccalf_row_offsets(h >> sy, sy, ctu, ctu - 4),
                            RAK.ccalf_row_offsets(h >> sy, sy, ctu, ctu - 4)):
                np.testing.assert_array_equal(a, b)


def test_cpu_wrappers_take_the_plain_path():
    """A CPU tensor never reaches the kernel library."""
    from vtm_tpu_torch import kernels as KN

    rng = np.random.default_rng(17)
    src = T.plane(rng, 16, 16, 8)
    maps = T.sao_maps(rng, 16, 16, 1, 8)
    before = KN.launch_counts()
    SK.sao_apply(t(src), *map(t, maps), bit_depth=8)
    assert KN.launch_counts() == before


@pytest.mark.cuda
def test_cuda_kernels_match_plain():
    """Each CUDA kernel equals its plain version (10-bit 4:4:4 and 8-bit
    4:2:0 seeded cases), on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    dev = torch.device("cuda")
    for fmt, bd in (("420", 8), ("444", 10)):
        rng = np.random.default_rng(18)
        sx, sy = T.FORMATS[fmt]
        y, cb, cr = (to_device(p, dev) for p in T.planes(rng, 128, 256, fmt, bd))
        for hor in (False, True):
            maps = [to_device(m, dev) for m in T.deblock_maps(rng, 128, 256, bd, hor)]
            kw = dict(bit_depth=bd, hor=hor, has_l=True, has_cb=True,
                      has_cr=True, sx=sx, sy=sy)
            for a, b in zip(DK.deblock_dir(y, cb, cr, *maps, **kw),
                            DK.deblock_dir_plain(y, cb, cr, *maps, **kw)):
                assert torch.equal(a, b)
        lmaps = [to_device(m, dev) for m in T.deblock_maps(rng, 128, 256, bd, False)[:7]]
        assert torch.equal(DK.deblock_luma_ver(y, *lmaps, bit_depth=bd),
                           DK.deblock_luma_ver(y.cpu(), *(m.cpu() for m in lmaps),
                                               bit_depth=bd).to(dev))
        sao = [to_device(m, dev) for m in T.sao_maps(rng, 128, 256, 8, bd)]
        assert torch.equal(SK.sao_apply(y, *sao, bit_depth=bd),
                           SK.sao_apply_plain(y, *sao, bit_depth=bd))
        args = [to_device(a, dev) for a in T.alf_tables(rng, 128, 256, fmt, bd, 64)]
        y_pad = to_device(np.pad(y.cpu().numpy(), AK.PAD, mode="edge"), dev)
        kw = dict(bit_depth=bd, sx=sx, sy=sy, has_l=True, has_cb=True,
                  has_cr=True, has_cc1=True, has_cc2=True)
        for a, b in zip(AK.alf_all(y_pad, cb, cr, *args, **kw),
                        AK.alf_all_plain(y_pad, cb, cr, *args, **kw)):
            assert torch.equal(a, b)
