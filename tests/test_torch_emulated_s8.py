"""The int8 tensor-core inverse transform (csrc/transform.cu
`vtm_inv_transform_s8`), built for the CPU by the test-support emulation of
tests/_emu with its tensor-core products emulated (tests/_emu/tc.cuh, a
warp-collective twin of csrc/tc.cuh's `mma_k32`), against the plain
version `inv_transform_batch_s8_plain`, at tolerance 0.

The emulated product is first held alone to an int64 numpy product.  Then
the kernel runs on every block shape and kind pair the entry takes, at 8
and 10 bits; at block counts around its group of 4,096 coefficients (a
group less one, one and a part of the next, several: the emulation keeps
one CTA resident, so it walks every group through both stage buffers); on
coefficients at the ends of the int16 range, with a low byte of 255 or a
high byte of -128, and beyond the int16 range (the high byte wraps as a
cast to int8 does); into outputs filled with a sentinel, with guard words
past the end; and with coefficients and output 4, 8 and 12 bytes off a
16-byte boundary.
"""

import ctypes
import shutil

import numpy as np
import pytest
import torch

from vtm_tpu_torch import kernels as KN
from vtm_tpu_torch.ops import transform as TR

SENTINEL = -12345
GUARD = 64  # sentinel words past each output
GROUP = 4096  # coefficients a CTA stages a step (csrc/transform.cu kS8GroupWords)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("the CPU emulation of the CUDA sources needs g++")
    from _emu import build

    lib = build.load(str(tmp_path_factory.mktemp("emu_s8")), ["transform.cu", "mma_probe.cu"])
    lib.emu_mma_k32.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
    lib.emu_mma_k32.restype = ctypes.c_int
    return lib


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The plain versions' small products on one thread: the emulation's
    host threads, one a CUDA thread, already fill the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def emu_launch(lib, monkeypatch):
    """The wrappers' launches go to the emulated library (CPU tensors)."""
    def launch(name, device, *args):
        err = getattr(lib, name)(*args, None)
        if err:
            raise RuntimeError(f"{name}: error {err}")
    monkeypatch.setattr(KN, "launch", launch)


def _fragment_bytes(rng, shape) -> np.ndarray:
    """Seeded bytes, a third of them the extremes 0x80, 0x7F, 0x00, 0xFF
    (-128, 127, 0, -1 signed; 128, 127, 0, 255 unsigned)."""
    b = rng.integers(0, 256, size=shape)
    ends = rng.choice(np.array([0x80, 0x7F, 0x00, 0xFF]), size=shape)
    return np.where(rng.random(shape) < 1 / 3, ends, b).astype(np.uint8)


@pytest.mark.parametrize("a_signed, b_signed",
                         [(1, 1), (1, 0), (0, 1), (0, 0)])
def test_emulated_mma(lib, a_signed, b_signed):
    """One m16n8k32 product through the emulated mma_k32 against numpy:
    seeded fragments with the extremes, then A and B all 0x80 and all 0xFF,
    C at the int32 ends (sums wrap as int32)."""
    rng = np.random.default_rng(7 + 2 * a_signed + b_signed)
    cases = [(_fragment_bytes(rng, (16, 32)), _fragment_bytes(rng, (32, 8)),
              rng.integers(-2 ** 31, 2 ** 31, size=(16, 8))) for _ in range(6)]
    for v in (0x80, 0xFF):
        cases.append((np.full((16, 32), v, np.uint8), np.full((32, 8), v, np.uint8),
                      np.resize([2 ** 31 - 1, -2 ** 31, 0], (16, 8))))
    for a, b, c in cases:
        c = c.astype(np.int32)
        d = np.full((16, 8), SENTINEL, np.int32)
        assert lib.emu_mma_k32(a.ctypes.data, b.ctypes.data, c.ctypes.data, d.ctypes.data,
                               a_signed, b_signed) == 0
        ai = (a.view(np.int8) if a_signed else a).astype(np.int64)
        bi = (b.view(np.int8) if b_signed else b).astype(np.int64)
        want = (ai @ bi + c.astype(np.int64) + 2 ** 31) % 2 ** 32 - 2 ** 31
        np.testing.assert_array_equal(d, want)


def _shape_pairs():
    """Every (h, w, tr_hor, tr_ver) that transform._check_shape accepts."""
    kinds = (TR.DCT2, TR.DCT8, TR.DST7)
    pairs = []
    for h in (2, 4, 8, 16, 32, 64):
        for w in (2, 4, 8, 16, 32, 64):
            for tr_hor in kinds:
                for tr_ver in kinds:
                    try:
                        TR._check_shape(h, w, tr_hor, tr_ver)
                    except ValueError:
                        continue
                    pairs.append((h, w, tr_hor, tr_ver))
    return pairs


def _coeffs(rng, n: int, h: int, w: int, wrap: bool = False) -> np.ndarray:
    """n blocks of seeded int16-range coefficients, a quarter of them
    -32768 or 32767, an eighth with the low byte 255, an eighth with the
    high byte -128; with `wrap`, a quarter beyond the int16 range."""
    shape = (n, h, w)
    c = rng.integers(-32768, 32768, size=shape)
    u = rng.random(shape)
    c = np.where(u < 0.25, rng.choice(np.array([-32768, 32767]), size=shape), c)
    c = np.where((u >= 0.25) & (u < 0.375), rng.integers(-128, 128, size=shape) * 256 + 255, c)
    c = np.where((u >= 0.375) & (u < 0.5), -32768 + rng.integers(0, 256, size=shape), c)
    if wrap:
        far = rng.integers(32768, 1 << 22, size=shape) * rng.choice(np.array([-1, 1]), size=shape)
        c = np.where(u >= 0.75, far, c)
    return c.astype(np.int32)


def _at_word(n: int, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(a view of n int32 words k words past a 16-byte boundary, the buffer
    it lies in, GUARD words longer), the buffer filled with the sentinel."""
    buf = torch.full((n + 4 + GUARD,), SENTINEL, dtype=torch.int32)
    off = (-buf.data_ptr() // 4) % 4 + k
    view = buf[off:off + n]
    assert view.data_ptr() % 16 == 4 * k
    return view, buf[off + n:]


def _check(lib, c: np.ndarray, tr_hor: int, tr_ver: int, bd: int, k_in: int = 0,
           k_out: int = 0) -> None:
    """vtm_inv_transform_s8 through the C entry, coefficients k_in and the
    output k_out words past a 16-byte boundary, into a sentinel-filled
    output, against the plain version; the guard words past the output
    keep the sentinel."""
    b, h, w = c.shape
    cin, _ = _at_word(c.size, k_in)
    cin.copy_(torch.from_numpy(c).reshape(-1))
    out, guard = _at_word(c.size, k_out)
    tv, th = TR._tmat(tr_ver, h, "cpu"), TR._tmat(tr_hor, w, "cpu")
    assert lib.vtm_inv_transform_s8(cin.data_ptr(), out.data_ptr(), tv.data_ptr(),
                                    th.data_ptr(), b, h, w, bd, None) == 0
    want = TR.inv_transform_batch_s8_plain(torch.from_numpy(c), bd, tr_hor, tr_ver)
    np.testing.assert_array_equal(out.view(b, h, w).numpy(), want.numpy())
    assert bool((guard == SENTINEL).all()), "a store past the last block"


@pytest.mark.parametrize("bd", [8, 10])
def test_s8_every_shape(emu_launch, bd):
    """inv_transform_batch_s8_cuda (the wrapper, its launch emulated)
    against the plain version on every block size and kind pair: three
    blocks each, a part of one group."""
    rng = np.random.default_rng(160 + bd)
    pairs = _shape_pairs()
    assert len(pairs) == 196
    for h, w, tr_hor, tr_ver in pairs:
        c = torch.from_numpy(_coeffs(rng, 3, h, w))
        np.testing.assert_array_equal(
            TR.inv_transform_batch_s8_cuda(c, bd, tr_hor, tr_ver).numpy(),
            TR.inv_transform_batch_s8_plain(c, bd, tr_hor, tr_ver).numpy())


# each of the six instantiations (stage-1 rows 16 / 32 / 64 by 32 / 64
# columns), small blocks stacked (h < 16) and side by side (w < 32) in a
# tile, square and not, DST7 / DCT8 too
GROUP_SHAPES = [(2, 2, TR.DCT2, TR.DCT2), (4, 4, TR.DST7, TR.DST7), (8, 8, TR.DCT2, TR.DCT2),
                (16, 16, TR.DCT8, TR.DST7), (32, 32, TR.DCT2, TR.DCT2),
                (64, 64, TR.DCT2, TR.DCT2), (4, 16, TR.DST7, TR.DCT8),
                (64, 2, TR.DCT2, TR.DCT2), (2, 64, TR.DCT2, TR.DCT2),
                (32, 64, TR.DCT2, TR.DCT2), (16, 8, TR.DCT2, TR.DCT2),
                (8, 32, TR.DCT8, TR.DST7)]


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("h, w, tr_hor, tr_ver", GROUP_SHAPES)
def test_s8_groups(lib, h, w, tr_hor, tr_ver, bd):
    """Block counts of a group less one, one group and a part of the next,
    and three groups and one, into sentinel-filled outputs with guard words
    past the end."""
    rng = np.random.default_rng(170 + h + 3 * w + bd)
    g = GROUP // (h * w)
    for b in sorted({max(g - 1, 1), g + g // 2 + 1, 3 * g + 1}):
        _check(lib, _coeffs(rng, b, h, w), tr_hor, tr_ver, bd)


@pytest.mark.parametrize("h, w", [(2, 2), (8, 8), (32, 32), (64, 64), (4, 16), (64, 2)])
def test_s8_wrap(lib, h, w):
    """Coefficients beyond the int16 range: the high byte wraps as a cast
    to int8 does in split_s8, so the result is that of the coefficients
    taken mod 2^16, which the int32 transform does not give."""
    rng = np.random.default_rng(180 + h + w)
    c = _coeffs(rng, GROUP // (h * w) + 1, h, w, wrap=True)
    _check(lib, c, TR.DCT2, TR.DCT2, 10)
    wrapped = ((c.astype(np.int64) + 32768) % 65536 - 32768).astype(np.int32)
    np.testing.assert_array_equal(
        TR.inv_transform_batch_s8_plain(torch.from_numpy(c), 10).numpy(),
        TR.inv_transform_batch_plain(torch.from_numpy(wrapped), 10).numpy())
    assert not torch.equal(TR.inv_transform_batch_s8_plain(torch.from_numpy(c), 10),
                           TR.inv_transform_batch_plain(torch.from_numpy(c), 10))


@pytest.mark.parametrize("k", [1, 2, 3])
def test_s8_unaligned(lib, k):
    """Coefficients and output 4 k bytes off a 16-byte boundary (4-, 8- and
    4-byte copies into the stage; 4-byte stores where the output is not
    8-byte aligned), each alone and both, over a group and a part."""
    rng = np.random.default_rng(190 + k)
    for h, w, tr_hor, tr_ver in [(2, 2, TR.DCT2, TR.DCT2), (8, 8, TR.DCT2, TR.DCT2),
                                 (4, 16, TR.DST7, TR.DCT8), (64, 64, TR.DCT2, TR.DCT2)]:
        c = _coeffs(rng, GROUP // (h * w) + 1, h, w)
        for k_in, k_out in ((k, 0), (0, k), (k, k)):
            _check(lib, c, tr_hor, tr_ver, 8, k_in, k_out)


def test_s8_refuses_other_sizes(lib):
    """A size the entry has no transform for (3, 128) is refused, not run."""
    c = torch.zeros(4 * 128 * 128, dtype=torch.int32)
    tv = TR._tmat(TR.DCT2, 4, "cpu")
    for h, w in ((3, 4), (4, 3), (128, 4), (4, 128), (1, 4)):
        assert lib.vtm_inv_transform_s8(c.data_ptr(), c.data_ptr(), tv.data_ptr(),
                                        tv.data_ptr(), 1, h, w, 8, None) != 0
