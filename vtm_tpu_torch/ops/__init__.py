"""Sample-path ops of the port: each kernel module holds a plain torch
version (the CPU path, and the reference the CUDA kernel is held to) and
the wrapper that launches the CUDA kernel for a CUDA tensor.

The helpers below keep the plain versions in the jax reference's int32
semantics."""

from __future__ import annotations

import torch


def edge_pad(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """jnp.pad(x, ((rows, rows), (cols, cols)), mode="edge") of a 2-D plane."""
    h, w = x.shape
    ri = torch.arange(-rows, h + rows, device=x.device).clamp_(0, h - 1)
    ci = torch.arange(-cols, w + cols, device=x.device).clamp_(0, w - 1)
    return x[ri[:, None], ci[None, :]]


def where(cond: torch.Tensor, a, b) -> torch.Tensor:
    """torch.where that keeps int32 when both branches are Python ints."""
    if not torch.is_tensor(a) and not torch.is_tensor(b):
        a = torch.tensor(a, dtype=torch.int32, device=cond.device)
    return torch.where(cond, a, b)


def clip3(lo, hi, v: torch.Tensor) -> torch.Tensor:
    """jnp.clip(v, lo, hi) == minimum(maximum(v, lo), hi): both bounds are
    ints or both tensors (and lo > hi gives hi, as in jax)."""
    if torch.is_tensor(lo):
        return torch.minimum(torch.maximum(v, lo), hi)
    return v.clamp(lo, hi)


def mul32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int32 product that wraps on overflow, as XLA's does."""
    p = (a.to(torch.int64) * b.to(torch.int64)) & 0xFFFFFFFF
    return (p - ((p >> 31) << 32)).to(torch.int32)


def clamp_index(i: torch.Tensor, n: int) -> torch.Tensor:
    """Gather index clamped into [0, n-1], as jax clamps it."""
    return i.to(torch.int64).clamp(0, n - 1)
