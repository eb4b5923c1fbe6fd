"""Hadamard SATD of difference blocks: plain torch version + CUDA wrapper.

Counterpart of vtm_tpu/ops/rdcost.py:satd_batch_jax (RdCost::xGetHADs
tiling with the mean-scaled DC term).  Each tile gets an unnormalised 2-D
Walsh-Hadamard transform; the tile's value is sum |coeff| - dc + (dc >> 2),
normalised per tile, and the block's SATD is the sum over its tiles:

    8x16 / 16x8 tiles: int32(float32(s) * float32(2 / sqrt(128)))
    4x8 / 8x4 tiles:   int32(float32(s) * float32(2 / sqrt(32)))
    8x8: (s + 2) >> 2    4x4: (s + 1) >> 1    2x2: s    otherwise SAD

The float32 product truncates toward zero, as jax's astype(int32) does;
numpy's float64 `satd_batch` differs from it by one on some 16x8 / 8x4
tiles, so the jax function is the one both versions here equal.

* CPU tensors: `satd_batch_plain`, exact-integer butterflies (never a
  float or integer matmul: on the card a float32 matmul may run as TF32,
  and CUDA torch has no integer matmul).
* CUDA tensors: csrc/rdcost.cu, one thread per tile, on the device
  function of csrc/satd.cuh that the RMD kernels (csrc/rmd.cu) share.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from vtm_tpu_torch import kernels as KN
from vtm_tpu_torch.ops import pick

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
    """diff int32 (..., h, w) -> (...,) int32 SATD, as satd_batch_jax."""
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
