"""Sample-path ops of the port: each kernel module holds a plain torch
version (the CPU path, and the reference the CUDA kernel is held to) and
the wrapper that launches the CUDA kernel for a CUDA tensor.

The helpers below keep the plain versions in the jax reference's int32
semantics.  Every copy between the host and the device on the decode path
goes through `host_to_device` or `to_host`, which count it (trace.py)."""

from __future__ import annotations

import numpy as np
import torch

from vtm_tpu_torch import trace


def pick(t: torch.Tensor, cuda_fn, plain_fn):
    """The kernel's wrapper for a CUDA tensor, the plain version for a CPU
    tensor; any other device raises."""
    if t.is_cuda:
        return cuda_fn
    if t.device.type == "cpu":
        return plain_fn
    raise ValueError(f"no kernel or plain version for a tensor on {t.device}")


def host_to_device(t: torch.Tensor, device) -> torch.Tensor:
    """A host tensor on `device`, in one copy, counted as `h2d_copies` and
    `h2d_bytes` (on the CPU too, where the move costs nothing)."""
    if t.numel():
        trace.count("h2d_copies")
        trace.count("h2d_bytes", t.nbytes)
    return t.to(device)


def to_host(t: torch.Tensor) -> torch.Tensor:
    """A device tensor on the host, in one copy (a sync), counted as
    `d2h_copies` (on the CPU too, where the move costs nothing)."""
    if t.numel():
        trace.count("d2h_copies")
    return t.cpu()


def upload(arrays, device: torch.device, dtype=np.int32) -> list[torch.Tensor]:
    """numpy arrays as contiguous tensors on `device`, moved in one copy:
    views of one packed buffer, each with its array's shape."""
    flat = [np.asarray(a, dtype=dtype).reshape(-1) for a in arrays]
    buf = torch.from_numpy(np.concatenate(flat) if flat else np.zeros(0, dtype))
    buf = host_to_device(buf, device)
    out, pos = [], 0
    for a, f in zip(arrays, flat):
        out.append(buf[pos:pos + f.size].view(np.shape(a)))
        pos += f.size
    return out


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


def shl32(a: torch.Tensor, k: int) -> torch.Tensor:
    """int32 left shift that wraps, as XLA's does (also for negatives)."""
    p = (a.to(torch.int64) << k) & 0xFFFFFFFF
    return (p - ((p >> 31) << 32)).to(torch.int32)


def clamp_index(i: torch.Tensor, n: int) -> torch.Tensor:
    """Gather index clamped into [0, n-1], as jax clamps it."""
    return i.to(torch.int64).clamp(0, n - 1)
