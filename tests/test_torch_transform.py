"""The port's batched inverse transforms against the jax reference.

The same numpy-seeded coefficient blocks go through vtm_tpu's
`inv_transform_batch` / `inv_transform_batch_mxu` (jax on the CPU) and the
port's plain versions `inv_transform_batch_plain` / `_s8_plain`; every
result must be equal (tolerance 0: integer arithmetic).  The shapes are
those of tests/test_transform.py plus the narrowest blocks (2 rows or 2
columns, DCT2's smallest size), at bit depths 8 and 10, with coefficients
at both ends of the int16 range.  The CUDA case holds both kernels to the
plain version on a card.
"""

import importlib
import importlib.util

import numpy as np
import pytest
import torch

from vtm_tpu_torch.ops import transform as T

DCT2, DST7, DCT8 = T.DCT2, T.DST7, T.DCT8
BATCH_SHAPES = [(4, 4), (8, 8), (16, 16), (32, 32), (4, 16), (32, 8), (64, 64),
                (2, 2), (2, 64), (64, 2), (2, 16), (16, 2)]
MXU_SHAPES = [(4, 4), (8, 8), (32, 32), (16, 4), (2, 8), (8, 2)]
KINDS = [(DCT2, DCT2), (DST7, DCT8), (DCT8, DST7)]


@pytest.fixture
def RT():
    if importlib.util.find_spec("jax") is None:
        pytest.skip("the jax reference needs jax")
    return importlib.import_module("vtm_tpu.ops.transform")


def coeffs(seed, n, h, w):
    """n blocks of int16-range coefficients; the first two at the extremes."""
    rng = np.random.default_rng(seed)
    c = rng.integers(-32768, 32768, size=(n, h, w)).astype(np.int32)
    c[0] = -32768
    c[1] = 32767
    c[2] = np.where((np.arange(h)[:, None] + np.arange(w)) % 2, 32767, -32768)
    return c


def fits(h, w, tr_hor, tr_ver):
    try:
        T._check_shape(h, w, tr_hor, tr_ver)
    except ValueError:
        return False
    return True


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("h,w", BATCH_SHAPES)
def test_inv_transform_batch_plain(RT, h, w, bd):
    c = coeffs(h * 100 + w, 6, h, w)
    want = np.asarray(RT.inv_transform_batch(c, bd))
    got = T.inv_transform_batch(torch.from_numpy(c), bd)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("kinds", KINDS)
@pytest.mark.parametrize("h,w", MXU_SHAPES)
def test_inv_transform_batch_s8_plain(RT, h, w, kinds, bd):
    tr_hor, tr_ver = kinds
    if not fits(h, w, tr_hor, tr_ver):
        pytest.skip("no DST7 / DCT8 of size 2")
    c = coeffs(h * 7 + w, 5, h, w)
    want = np.asarray(RT.inv_transform_batch_mxu(c, bd, tr_hor, tr_ver))
    got = T.inv_transform_batch_s8(torch.from_numpy(c), bd, tr_hor, tr_ver)
    np.testing.assert_array_equal(got.numpy(), want)
    # and the int8 form is the int32 function
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(RT.inv_transform_batch(c, bd, tr_hor, tr_ver)))


def test_transform_kinds_cover_every_size():
    """Every (size, kind) that rom.tr_matrix holds, both forms, one block."""
    rng = np.random.default_rng(1)
    for kind, sizes in ((DCT2, (2, 4, 8, 16, 32, 64)), (DST7, (4, 8, 16, 32)),
                        (DCT8, (4, 8, 16, 32))):
        for n in sizes:
            c = torch.from_numpy(rng.integers(-32768, 32768, size=(2, n, n))
                                 .astype(np.int32))
            a = T.inv_transform_batch(c, 10, kind, kind)
            b = T.inv_transform_batch_s8(c, 10, kind, kind)
            assert torch.equal(a, b)


@pytest.mark.parametrize("h,w,kinds", [(1, 8, (DCT2, DCT2)), (8, 1, (DCT2, DCT2)),
                                       (2, 4, (DCT2, DST7)), (128, 4, (DCT2, DCT2))])
def test_shapes_without_a_matrix_raise(RT, h, w, kinds):
    """A size rom.tr_matrix lacks (1 point, 2-point DST7, 128 points) has no
    transform in the reference either."""
    c = np.zeros((1, h, w), np.int32)
    with pytest.raises(KeyError):
        RT.inv_transform_batch(c, 8, *kinds)
    for fn in (T.inv_transform_batch, T.inv_transform_batch_s8):
        with pytest.raises(ValueError):
            fn(torch.from_numpy(c), 8, *kinds)


@pytest.mark.cuda
def test_cuda_transforms_match_plain():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    dev = torch.device("cuda")
    for h, w in BATCH_SHAPES:
        for tr_hor, tr_ver in KINDS:
            if not fits(h, w, tr_hor, tr_ver):
                continue
            c = torch.from_numpy(coeffs(h + w, 300, h, w)).to(dev)
            for bd in (8, 10):
                want = T.inv_transform_batch_plain(c, bd, tr_hor, tr_ver)
                assert torch.equal(T.inv_transform_batch_cuda(c, bd, tr_hor, tr_ver), want)
                assert torch.equal(T.inv_transform_batch_s8_cuda(c, bd, tr_hor, tr_ver),
                                   want)
