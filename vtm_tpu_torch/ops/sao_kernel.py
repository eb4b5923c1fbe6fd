"""SAO application: plain torch version + CUDA wrapper.

Counterpart of vtm_tpu/ops/sao_kernel.py.  Each sample's edge class is
sgn(c - nA) + sgn(c - nB) on the pre-SAO plane (edge-replicated at the
border), or its band c >> (bd - 5); the offset comes from the per-CTU table,
and samples outside the validity mask pass through.

* CPU tensors: `sao_apply_plain`.
* CUDA tensors: csrc/sao.cu, one thread per sample.
"""

from __future__ import annotations

import torch

from vtm_tpu_torch import kernels as KN
from vtm_tpu_torch.ops import clamp_index, edge_pad


def sao_apply_plain(src, type_map, ctu_map, offsets, valid, bit_depth: int):
    """src int32 [H, W]; type_map 0..4 (4 = band); ctu_map CTU address per
    pixel; offsets int32 [n_ctu, 32]; valid bool [H, W]."""
    maxv = (1 << bit_depth) - 1
    H, W = src.shape
    pad = edge_pad(src, 1, 1)
    c = src

    def sh(dy, dx):
        return pad[1 + dy:1 + dy + H, 1 + dx:1 + dx + W]

    def edge(a, b):
        return torch.sign(c - a) + torch.sign(c - b) + 2

    e0 = edge(sh(0, -1), sh(0, 1))
    e90 = edge(sh(-1, 0), sh(1, 0))
    e135 = edge(sh(-1, -1), sh(1, 1))
    e45 = edge(sh(-1, 1), sh(1, -1))
    band = c >> (bit_depth - 5)
    idx = torch.where(type_map == 0, e0, torch.where(
        type_map == 1, e90, torch.where(
            type_map == 2, e135, torch.where(type_map == 3, e45, band))))
    off = offsets[clamp_index(ctu_map, offsets.shape[0]),
                  clamp_index(idx, offsets.shape[1])]
    out = (c + off).clamp(0, maxv)
    return torch.where(valid, out, c)


def sao_apply_cuda(src, type_map, ctu_map, offsets, valid, bit_depth: int):
    dev = src.device
    H, W = src.shape
    KN.check(src, "src", torch.int32, dev)
    KN.check(type_map, "type_map", torch.int32, dev, (H, W))
    KN.check(ctu_map, "ctu_map", torch.int32, dev, (H, W))
    KN.check(valid, "valid", torch.bool, dev, (H, W))
    KN.check(offsets, "offsets", torch.int32, dev, (offsets.shape[0], 32))
    out = torch.empty_like(src)
    KN.launch("vtm_sao_apply", dev, src.data_ptr(), out.data_ptr(),
              type_map.data_ptr(), ctu_map.data_ptr(), offsets.data_ptr(),
              valid.data_ptr(), H, W, offsets.shape[0], bit_depth)
    return out


def sao_apply(src, type_map, ctu_map, offsets, valid, bit_depth: int):
    """SAO of one plane: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors."""
    fn = sao_apply_cuda if src.is_cuda else sao_apply_plain
    return fn(src, type_map, ctu_map, offsets, valid, bit_depth=bit_depth)
