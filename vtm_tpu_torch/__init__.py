"""vtm_tpu_torch: the VVC decoder and all-intra encoder of `vtm_tpu` on
PyTorch and CUDA.

All-intra, inter and IBC decode run end to end: parsing, CABAC, MV
derivation, intra, affine and IBC prediction, inverse transform and LMCS
forward mapping come unchanged from `vtm_tpu`'s host modules (numpy); the
slice's translational MC, DMVR, BDOF and the in-loop filter chain (LMCS
inverse, deblocking, SAO, ALF / CC-ALF) run on a torch device, through
hand-written CUDA kernels (`csrc/`) on a GPU and through their plain torch
versions on the CPU.

All-intra encode runs end to end too (`encoder/`): the RD search, CABAC
writer and filter-parameter searches are `vtm_tpu`'s; the whole-frame
batched RMD (67 modes and MIP, Hadamard SATD) and the encoder's deblocking,
SAO and ALF run on the torch device, through the same split of kernels and
plain versions.

This package imports torch and numpy, never jax.
"""

import os

# vtm_tpu/__init__ would otherwise try `import jax` to set a compile cache
os.environ.setdefault("VTM_TPU_NO_JIT_CACHE", "1")

__version__ = "0.1.0"
