"""Picture SAO of the encoder's reconstruction on a torch device.

Counterpart of vtm_tpu/ops/sao.py:sao_picture (L23-38): vtm_tpu's
`build_sao_maps` (merges and offsets resolved on the host), then the port's
`sao_apply` per active component (csrc/sao.cu on a GPU, the plain version
on the CPU), written back in place into `pic.planes`.
"""

from __future__ import annotations

from vtm_tpu.ops.sao import build_sao_maps
from vtm_tpu_torch.ops import sao_kernel as SK
from vtm_tpu_torch.ops.filter_chain import to_device


def sao_picture(dcs, pic, device) -> None:
    """SAOProcess over the picture from pic.sao_params."""
    for comp, args in enumerate(build_sao_maps(dcs, pic)):
        if args is None:
            continue
        plane = pic.planes[comp]
        out = SK.sao_apply(to_device(plane, device),
                           *(to_device(a, device) for a in args),
                           bit_depth=dcs.sps.bit_depth)
        plane[:] = out.cpu().numpy().astype(plane.dtype)
