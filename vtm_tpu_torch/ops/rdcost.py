"""Distortion function registry — SAD / SSE / Hadamard SATD.

Behavioral contract from CommonLib/RdCost.cpp: the HAD family
(xGetHADs:2819 tiling dispatch; xCalcHADs8x8:2294, 4x4:2166, 2x2:2140,
16x8/8x16:2385/2526, 8x4/4x8:2659/2742) with the JVET-R0164 mean-scaled
DC term (TypeDef.h:62).  Each tile applies an unnormalized 2-D Hadamard
transform to the difference block, sums |coeff| with the DC term scaled
by 1/4, then normalizes by 2/sqrt(N):

    8x8  -> (s + 2) >> 2          4x4 -> (s + 1) >> 1
    16x8 -> int(s / sqrt(128) * 2) 8x4 -> int(s / sqrt(32) * 2)

Implemented as matrix products H_h @ D @ H_w^T with Sylvester-ordered
+-1 Hadamard matrices (row 0 = all ones, so [0,0] is the DC term; the
abs-coefficient sum is invariant to the reference's butterfly ordering).

Two implementations: numpy (scalar encoder paths: satd, satd_batch) and
the batched form of the device RMD (`satd_batch`'s torch counterpart
below, `satd_batch_plain` / `satd_batch_cuda`).

The batched form is the counterpart of the reference's jax kernel
(RdCost::xGetHADs tiling with the mean-scaled DC term).  Each tile gets an
unnormalised 2-D Walsh-Hadamard transform; the tile's value is
sum |coeff| - dc + (dc >> 2), normalised per tile, and the block's SATD is
the sum over its tiles:

    8x16 / 16x8 tiles: int32(float32(s) * float32(2 / sqrt(128)))
    4x8 / 8x4 tiles:   int32(float32(s) * float32(2 / sqrt(32)))
    8x8: (s + 2) >> 2    4x4: (s + 1) >> 1    2x2: s    otherwise SAD

The float32 product truncates toward zero, as the device kernel of the
reference does; the float64 `satd_batch` differs from it by one on some
16x8 / 8x4 tiles, so the batched versions keep float32.

* CPU tensors: `satd_batch_plain`, exact-integer butterflies (never a
  float or integer matmul: on the card a float32 matmul may run as TF32,
  and CUDA torch has no integer matmul).
* CUDA tensors: csrc/rdcost.cu, one launch a call: lanes take tile rows
  (rows_satd_tile of csrc/satd.cuh, whose one-row-a-lane case the RMD
  kernels of csrc/rmd.cu share) and each block's sum is stored once, so
  `out` needs no zeroing.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from vtm_tpu_torch import kernels as KN
from vtm_tpu_torch.ops import pick

_SQRT_NORM_16x8 = 2.0 / math.sqrt(16.0 * 8)
_SQRT_NORM_8x4 = 2.0 / math.sqrt(4.0 * 8)


def _hadamard(n: int) -> np.ndarray:
    h = np.array([[1]], dtype=np.int64)
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return h


_H = {n: _hadamard(n) for n in (2, 4, 8, 16)}


def _tile_satd_sum(d: np.ndarray, th: int, tw: int) -> np.ndarray:
    """Mean-scaled abs-coefficient sum per (th, tw) tile.

    d: (..., th, tw) int64 difference tiles -> (...,) sums (pre-norm).
    """
    m = _H[th] @ d @ _H[tw].T
    a = np.abs(m)
    s = a.sum(axis=(-2, -1))
    dc = a[..., 0, 0]
    return s - dc + (dc >> 2)


def _tiles(d: np.ndarray, th: int, tw: int) -> np.ndarray:
    h, w = d.shape[-2:]
    lead = d.shape[:-2]
    t = d.reshape(*lead, h // th, th, w // tw, tw)
    return np.moveaxis(t, -3, -2)  # (..., h/th, w/tw, th, tw)


def satd(org: np.ndarray, cur: np.ndarray) -> int:
    """RdCost::xGetHADs — full-block Hadamard SATD (mean-scaled)."""
    d = org.astype(np.int64) - cur.astype(np.int64)
    h, w = d.shape
    if w > h and h % 8 == 0 and w % 16 == 0:
        s = _tile_satd_sum(_tiles(d, 8, 16), 8, 16)
        return int((s.astype(np.float64) * _SQRT_NORM_16x8).astype(np.int64).sum())
    if w < h and w % 8 == 0 and h % 16 == 0:
        s = _tile_satd_sum(_tiles(d, 16, 8), 16, 8)
        return int((s.astype(np.float64) * _SQRT_NORM_16x8).astype(np.int64).sum())
    if w > h and h % 4 == 0 and w % 8 == 0:
        s = _tile_satd_sum(_tiles(d, 4, 8), 4, 8)
        return int((s.astype(np.float64) * _SQRT_NORM_8x4).astype(np.int64).sum())
    if w < h and w % 4 == 0 and h % 8 == 0:
        s = _tile_satd_sum(_tiles(d, 8, 4), 8, 4)
        return int((s.astype(np.float64) * _SQRT_NORM_8x4).astype(np.int64).sum())
    if h % 8 == 0 and w % 8 == 0:
        s = _tile_satd_sum(_tiles(d, 8, 8), 8, 8)
        return int(((s + 2) >> 2).sum())
    if h % 4 == 0 and w % 4 == 0:
        s = _tile_satd_sum(_tiles(d, 4, 4), 4, 4)
        return int(((s + 1) >> 1).sum())
    if h % 2 == 0 and w % 2 == 0:
        s = _tile_satd_sum(_tiles(d, 2, 2), 2, 2)
        return int(s.sum())
    return int(np.abs(d).sum())


def satd_batch(org: np.ndarray, cur: np.ndarray) -> np.ndarray:
    """Batched SATD: org/cur (..., h, w) -> (...,) int64, same tiling."""
    d = org.astype(np.int64) - cur.astype(np.int64)
    h, w = d.shape[-2:]
    if w > h and h % 8 == 0 and w % 16 == 0:
        s = _tile_satd_sum(_tiles(d, 8, 16), 8, 16)
        return (s.astype(np.float64) * _SQRT_NORM_16x8).astype(np.int64).sum(axis=(-2, -1))
    if w < h and w % 8 == 0 and h % 16 == 0:
        s = _tile_satd_sum(_tiles(d, 16, 8), 16, 8)
        return (s.astype(np.float64) * _SQRT_NORM_16x8).astype(np.int64).sum(axis=(-2, -1))
    if w > h and h % 4 == 0 and w % 8 == 0:
        s = _tile_satd_sum(_tiles(d, 4, 8), 4, 8)
        return (s.astype(np.float64) * _SQRT_NORM_8x4).astype(np.int64).sum(axis=(-2, -1))
    if w < h and w % 4 == 0 and h % 8 == 0:
        s = _tile_satd_sum(_tiles(d, 8, 4), 8, 4)
        return (s.astype(np.float64) * _SQRT_NORM_8x4).astype(np.int64).sum(axis=(-2, -1))
    if h % 8 == 0 and w % 8 == 0:
        return ((_tile_satd_sum(_tiles(d, 8, 8), 8, 8) + 2) >> 2).sum(axis=(-2, -1))
    if h % 4 == 0 and w % 4 == 0:
        return ((_tile_satd_sum(_tiles(d, 4, 4), 4, 4) + 1) >> 1).sum(axis=(-2, -1))
    if h % 2 == 0 and w % 2 == 0:
        return _tile_satd_sum(_tiles(d, 2, 2), 2, 2).sum(axis=(-2, -1))
    return np.abs(d).sum(axis=(-2, -1))


def sad(org: np.ndarray, cur: np.ndarray) -> int:
    return int(np.abs(org.astype(np.int64) - cur.astype(np.int64)).sum())


def sse(org: np.ndarray, cur: np.ndarray) -> int:
    d = org.astype(np.int64) - cur.astype(np.int64)
    return int((d * d).sum())


# ---------------------------------------------------------------------------
# batched form (device RMD)

# Tile kinds in RdCost::xGetHADs's order of preference, as (rows, cols);
# csrc/satd.cuh numbers them the same way.
KINDS = ((8, 16), (16, 8), (4, 8), (8, 4), (8, 8), (4, 4), (2, 2), (1, 1))
SAD = len(KINDS) - 1
NORM_16x8 = np.float32(2.0 / math.sqrt(16.0 * 8))
NORM_8x4 = np.float32(2.0 / math.sqrt(4.0 * 8))


def satd_kind(h: int, w: int) -> int:
    """Index in KINDS of the tile an h x w block is cut into."""
    if w > h and h % 8 == 0 and w % 16 == 0:
        return 0
    if w < h and w % 8 == 0 and h % 16 == 0:
        return 1
    if w > h and h % 4 == 0 and w % 8 == 0:
        return 2
    if w < h and w % 4 == 0 and h % 8 == 0:
        return 3
    if h % 8 == 0 and w % 8 == 0:
        return 4
    if h % 4 == 0 and w % 4 == 0:
        return 5
    if h % 2 == 0 and w % 2 == 0:
        return 6
    return SAD


def _fwht(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sylvester-ordered Walsh-Hadamard transform along `dim` (a power of
    two long), by butterflies: exact in int32."""
    x = x.movedim(dim, -1)
    lead, n = x.shape[:-1], x.shape[-1]
    s = 1
    while s < n:
        v = x.reshape(*lead, n // (2 * s), 2, s)
        a, b = v[..., 0, :], v[..., 1, :]
        x = torch.stack((a + b, a - b), dim=-2).reshape(*lead, n)
        s *= 2
    return x.movedim(-1, dim)


def _tile_sums(d: torch.Tensor, th: int, tw: int) -> torch.Tensor:
    """Mean-scaled abs-coefficient sum of every (th, tw) tile:
    (..., h, w) -> (..., h/th, w/tw)."""
    h, w = d.shape[-2:]
    t = d.reshape(*d.shape[:-2], h // th, th, w // tw, tw).transpose(-3, -2)
    a = _fwht(_fwht(t, -2), -1).abs()
    s = a.sum(dim=(-2, -1), dtype=torch.int32)
    dc = a[..., 0, 0]
    return s - dc + (dc >> 2)


def satd_batch_plain(diff: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """diff int32 (..., h, w) -> (...,) int32 SATD of each block."""
    kind = satd_kind(h, w)
    if kind == SAD:
        return diff.abs().sum(dim=(-2, -1), dtype=torch.int32)
    th, tw = KINDS[kind]
    s = _tile_sums(diff, th, tw)
    if kind < 4:
        norm = torch.tensor(NORM_16x8 if kind < 2 else NORM_8x4,
                            dtype=torch.float32, device=diff.device)
        s = (s.to(torch.float32) * norm).to(torch.int32)
    elif kind == 4:
        s = (s + 2) >> 2
    elif kind == 5:
        s = (s + 1) >> 1
    return s.sum(dim=(-2, -1), dtype=torch.int32)


def satd_batch_cuda(diff: torch.Tensor, h: int, w: int) -> torch.Tensor:
    dev = diff.device
    KN.check(diff, "diff", torch.int32, dev)
    if tuple(diff.shape[-2:]) != (h, w):
        raise ValueError(f"diff blocks are {tuple(diff.shape[-2:])}, not {(h, w)}")
    lead = diff.shape[:-2]
    out = torch.empty(lead, dtype=torch.int32, device=dev)
    n = out.numel()
    if n:
        KN.launch("vtm_satd_batch", dev, diff.data_ptr(), out.data_ptr(), n, h, w)
    return out


def satd_batch(diff: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """SATD of each h x w difference block: the CUDA kernel for a CUDA
    tensor, the plain version for a CPU tensor."""
    return pick(diff, satd_batch_cuda, satd_batch_plain)(diff, h, w)
