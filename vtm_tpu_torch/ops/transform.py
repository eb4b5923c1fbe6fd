"""VVC primary transforms (DCT2 / DST7 / DCT8), forward and inverse.

Behavioral contract from the reference (TrQuant.cpp:776 xT, :853 xIT;
TrQuant_EMT.cpp fastForward/Inverse*): separable integer transforms with
6-bit basis matrices (`rom.tr_matrix`), stage shifts

    inverse: shift1 = 7,              shift2 = 20 - bitDepth
    forward: shift1 = log2W + bitDepth + 6 - 15, shift2 = log2H + 6

and clipping of every stage output to [-2^15, 2^15-1] on the inverse path.
Inverse order is vertical then horizontal; forward is horizontal then
vertical.  Zero-out rules (>32-point DCT2, >16-point DST7/DCT8) are
enforced where coefficients are produced; on the inverse path the zeroed
region is zero so full matmuls are bit-exact.

Implementations:
  * numpy `*_np` — exact int64 scalar reference used by the conformance
    decoder.
  * batched inverse on a torch device, the counterparts of the reference's
    `inv_transform_batch` (transform.py:131) and `inv_transform_batch_mxu`
    (L152): (B, H, W) int32 blocks, stage 1 vertical (Tv^T c + 64) >> 7,
    stage 2 horizontal with shift 20 - bd, each clipped to int16.  Both
    stages run for every block shape (no 1-D branch, as in the reference's
    batched form); H and W are sizes `rom.tr_matrix` has (DCT2 2-64,
    DST7 / DCT8 4-32).
    - `inv_transform_batch`: `_plain` (exact: float64 matmuls of integers,
      whose products and sums stay far below 2^53) and `_cuda`
      (csrc/transform.cu `vtm_inv_transform`, int32 MACs);
    - `inv_transform_batch_s8`: the int8 form.  Each int16 operand x is
      split into hi = (x - (x & 255)) >> 8 and lo - 128 = (x & 255) - 128,
      both int8; a stage is two int8 x int8 -> int32 products plus the
      correction 128 * sum(t), and (hi << 8) + lo gives the int32 result
      exactly.  `_plain` repeats that arithmetic; `_cuda`
      (`vtm_inv_transform_s8`) runs the products on the int8 tensor cores
      (mma.sync m16n8k32).  It equals `inv_transform_batch`.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from vtm_tpu_torch import kernels as KN
from vtm_tpu_torch.common import rom
from vtm_tpu_torch.ops import pick

MAX_LOG2_TR_DYNAMIC_RANGE = 15
COEFF_MIN = -(1 << MAX_LOG2_TR_DYNAMIC_RANGE)
COEFF_MAX = (1 << MAX_LOG2_TR_DYNAMIC_RANGE) - 1

DCT2, DCT8, DST7 = 0, 1, 2
_KIND_NAME = {DCT2: "DCT2", DCT8: "DCT8", DST7: "DST7"}


@functools.cache
def _mat(kind: int, size: int, forward: bool) -> np.ndarray:
    return rom.tr_matrix(_KIND_NAME[kind], size, forward).astype(np.int64)


def inv_transform_2d_np(
    coeff: np.ndarray, bit_depth: int, tr_hor: int = DCT2, tr_ver: int = DCT2
) -> np.ndarray:
    """Exact inverse 2D transform of an (H, W) int coefficient block."""
    h, w = coeff.shape
    c = coeff.astype(np.int64)
    shift1 = 7
    shift2 = 20 - bit_depth
    if h > 1 and w > 1:
        tv = _mat(tr_ver, h, forward=False)
        tmp = (tv.T @ c + (1 << (shift1 - 1))) >> shift1
        tmp = np.clip(tmp, COEFF_MIN, COEFF_MAX)
        th = _mat(tr_hor, w, forward=False)
        out = (tmp @ th + (1 << (shift2 - 1))) >> shift2
        return np.clip(out, COEFF_MIN, COEFF_MAX).astype(np.int32)
    # 1-D cases get the +1 shift folded in (xIT 1-D branches)
    if w == 1:
        tv = _mat(tr_ver, h, forward=False)
        s = shift2 + 1
        out = (tv.T @ c + (1 << (s - 1))) >> s
    else:
        th = _mat(tr_hor, w, forward=False)
        s = shift2 + 1
        out = (c @ th + (1 << (s - 1))) >> s
    return np.clip(out, COEFF_MIN, COEFF_MAX).astype(np.int32)


def fwd_transform_2d_np(
    resi: np.ndarray, bit_depth: int, tr_hor: int = DCT2, tr_ver: int = DCT2
) -> np.ndarray:
    """Exact forward 2D transform of an (H, W) residual block.

    Returns the coefficient block with zero-out applied (ref xT skipWidth/
    skipHeight): DCT2 keeps at most 32 low-freq coeffs per dim, DST7/DCT8
    at 32-point keep 16.
    """
    h, w = resi.shape
    r = resi.astype(np.int64)
    log2w, log2h = int(np.log2(w)), int(np.log2(h))
    def rnd(s: int) -> int:
        return (1 << (s - 1)) if s > 0 else 0

    if h > 1 and w > 1:
        shift1 = log2w + bit_depth + 6 - MAX_LOG2_TR_DYNAMIC_RANGE
        shift2 = log2h + 6
        th = _mat(tr_hor, w, forward=True)
        # horizontal first: rows of resi → coeff index
        tmp = (r @ th.T + rnd(shift1)) >> shift1
        tv = _mat(tr_ver, h, forward=True)
        out = (tv @ tmp + rnd(shift2)) >> shift2
    elif h == 1:
        shift = log2w + bit_depth + 6 - MAX_LOG2_TR_DYNAMIC_RANGE
        th = _mat(tr_hor, w, forward=True)
        out = (r @ th.T + rnd(shift)) >> shift
    else:
        shift = log2h + bit_depth + 6 - MAX_LOG2_TR_DYNAMIC_RANGE
        tv = _mat(tr_ver, h, forward=True)
        out = (tv @ r + rnd(shift)) >> shift
    out = out.astype(np.int32)
    # zero-out
    zw = 16 if (tr_hor != DCT2 and w == 32) else min(w, 32)
    zh = 16 if (tr_ver != DCT2 and h == 32) else min(h, 32)
    if w > zw:
        out[:, zw:] = 0
    if h > zh:
        out[zh:, :] = 0
    return out


# ---------------------------------------------------------------------------
# batched inverse transform on a torch device


def _check_shape(h: int, w: int, tr_hor: int, tr_ver: int) -> None:
    for n, kind in ((h, tr_ver), (w, tr_hor)):
        sizes = (2, 4, 8, 16, 32, 64) if kind == DCT2 else (4, 8, 16, 32)
        if n not in sizes:
            raise ValueError(f"no {_KIND_NAME[kind]} of size {n}: the "
                             f"inverse transform takes {sizes}")


_DEV_MATS: dict = {}


def _tmat(kind: int, size: int, device, dtype=torch.int32) -> torch.Tensor:
    """rom.tr_matrix of the inverse transform on `device`, cached."""
    key = (kind, size, str(device), dtype)
    t = _DEV_MATS.get(key)
    if t is None:
        t = torch.from_numpy(_mat(kind, size, False)).to(device=device, dtype=dtype)
        _DEV_MATS[key] = t
    return t


def _clip16(x: torch.Tensor) -> torch.Tensor:
    return x.clamp(COEFF_MIN, COEFF_MAX)


def inv_transform_batch_plain(coeff: torch.Tensor, bit_depth: int,
                              tr_hor: int = DCT2, tr_ver: int = DCT2) -> torch.Tensor:
    """coeff int32 (B, H, W) -> int32 residuals (B, H, W)."""
    _, h, w = coeff.shape
    _check_shape(h, w, tr_hor, tr_ver)
    shift2 = 20 - bit_depth
    tv = _tmat(tr_ver, h, coeff.device, torch.float64)
    th = _tmat(tr_hor, w, coeff.device, torch.float64)
    tmp = torch.matmul(tv.T, coeff.to(torch.float64)).to(torch.int64)
    tmp = _clip16((tmp + 64) >> 7)
    out = torch.matmul(tmp.to(torch.float64), th).to(torch.int64)
    return _clip16((out + (1 << (shift2 - 1))) >> shift2).to(torch.int32)


def _split_s8(x: torch.Tensor):
    """int16-range x -> (hi, lo - 128), both int8-valued int64; hi wraps to
    int8 as a cast to int8 does."""
    lo = x & 0xFF
    hi = (((x - lo) >> 8) + 128) % 256 - 128
    return hi, lo - 128


def inv_transform_batch_s8_plain(coeff: torch.Tensor, bit_depth: int,
                                 tr_hor: int = DCT2, tr_ver: int = DCT2) -> torch.Tensor:
    """The int8 hi/lo form of inv_transform_batch_plain, product by product."""
    _, h, w = coeff.shape
    _check_shape(h, w, tr_hor, tr_ver)
    shift2 = 20 - bit_depth
    tv = _tmat(tr_ver, h, coeff.device, torch.float64)
    th = _tmat(tr_hor, w, coeff.device, torch.float64)

    def exact(a, b):
        return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(torch.int64)

    hi, lo = _split_s8(coeff.to(torch.int64))
    corr = 128 * tv.sum(dim=0).to(torch.int64)[:, None]      # (H, 1)
    acc = exact(tv.T, hi) * 256 + exact(tv.T, lo) + corr
    tmp = _clip16((acc + 64) >> 7)
    hi, lo = _split_s8(tmp)
    corr = 128 * th.sum(dim=0).to(torch.int64)[None, :]      # (1, W)
    acc = exact(hi, th) * 256 + exact(lo, th) + corr
    return _clip16((acc + (1 << (shift2 - 1))) >> shift2).to(torch.int32)


def _transform_cuda(entry: str, coeff, bit_depth, tr_hor, tr_ver):
    dev = coeff.device
    KN.check(coeff, "coeff", torch.int32, dev)
    b, h, w = coeff.shape
    _check_shape(h, w, tr_hor, tr_ver)
    out = torch.empty_like(coeff)
    if b:
        KN.launch(entry, dev, coeff.data_ptr(), out.data_ptr(),
                  _tmat(tr_ver, h, dev).data_ptr(), _tmat(tr_hor, w, dev).data_ptr(),
                  b, h, w, bit_depth)
    return out


def inv_transform_batch_cuda(coeff, bit_depth: int, tr_hor: int = DCT2,
                             tr_ver: int = DCT2):
    return _transform_cuda("vtm_inv_transform", coeff, bit_depth, tr_hor, tr_ver)


def inv_transform_batch_s8_cuda(coeff, bit_depth: int, tr_hor: int = DCT2,
                                tr_ver: int = DCT2):
    return _transform_cuda("vtm_inv_transform_s8", coeff, bit_depth, tr_hor, tr_ver)


def inv_transform_batch(coeff: torch.Tensor, bit_depth: int, tr_hor: int = DCT2,
                        tr_ver: int = DCT2) -> torch.Tensor:
    """Inverse transform of a (B, H, W) int32 batch: the CUDA kernel for a
    CUDA tensor, the plain version for a CPU tensor."""
    fn = pick(coeff, inv_transform_batch_cuda, inv_transform_batch_plain)
    return fn(coeff, bit_depth, tr_hor, tr_ver)


def inv_transform_batch_s8(coeff: torch.Tensor, bit_depth: int, tr_hor: int = DCT2,
                           tr_ver: int = DCT2) -> torch.Tensor:
    """The same function through int8 products (tensor cores on a GPU)."""
    fn = pick(coeff, inv_transform_batch_s8_cuda, inv_transform_batch_s8_plain)
    return fn(coeff, bit_depth, tr_hor, tr_ver)
