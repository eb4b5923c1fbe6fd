"""vtm_tpu_torch: the VVC decoder and all-intra encoder of `vtm_tpu` on
PyTorch and CUDA.

The package stands alone: it imports torch and numpy, and nothing of jax
or of `vtm_tpu`.  Its host modules (bitstream, parameter sets, CABAC with
its native C engine in `native/`, CTU syntax, MV derivation, intra,
affine and IBC prediction, inverse transform, LMCS, the encoder's RD
search and filter-parameter searches) are copies of `vtm_tpu`'s numpy
modules at the same relative paths.  The sample kernels run on a torch
device: hand-written CUDA kernels (`csrc/`) on a GPU, their plain torch
versions on the CPU.  That covers the decoder's translational MC, DMVR,
BDOF and in-loop filter chain (LMCS inverse, deblocking, SAO, ALF /
CC-ALF), the encoder's batched RMD with the Hadamard SATD and its filter
stages, the batched inverse transform, and the multi-device path of
`parallel/` (a mesh of lanes, each with its own torch device).
"""

__version__ = "0.1.0"
