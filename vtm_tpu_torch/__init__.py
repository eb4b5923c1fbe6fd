"""vtm_tpu_torch: the VVC decoder of `vtm_tpu` on PyTorch and CUDA.

All-intra decode runs end to end: parsing, CABAC, intra prediction,
inverse transform and LMCS forward mapping come unchanged from `vtm_tpu`'s
host modules (numpy); the in-loop filter chain (LMCS inverse, deblocking,
SAO, ALF / CC-ALF) runs on a torch device, through hand-written CUDA kernels
(`csrc/`) on a GPU and through their plain torch versions on the CPU.
Inter and IBC prediction are not ported yet.

This package imports torch and numpy, never jax.
"""

import os

# vtm_tpu/__init__ would otherwise try `import jax` to set a compile cache
os.environ.setdefault("VTM_TPU_NO_JIT_CACHE", "1")

__version__ = "0.1.0"
