"""Build and bind the port's CUDA kernels (`vtm_tpu_torch/csrc/*.cu`).

The sources are compiled with nvcc for Hopper (`sm_90a`), one nvcc process
per source, all at once, and linked into one shared library with a plain C
interface, loaded with ctypes.  The build happens at first use, into
`vtm_tpu_torch/_build/`, and again whenever a source is newer than the
library.  Nothing here runs at import time, so the module imports on a
machine without nvcc or a GPU.

Every launch goes through `launch()`: it passes the caller's pointers and
the current CUDA stream, raises on a non-zero `cudaError_t` from the entry
point (its `cudaGetLastError()` right after the launch), and counts the
launch per kernel.  The counts let a run show that its main path went
through the kernels.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

import torch

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libvtm_kernels.so")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C entry point -> argument types (pointers and the stream as c_void_p)
_SIGNATURES = {
    "vtm_deblock_luma_ver": (_P, _P, _I, _I, _LL, _LL, _P, _P, _P, _P, _P,
                             _P, _P, _LL, _LL, _I, _P),
    "vtm_deblock_chroma_ver": (_P, _P, _P, _P, _I, _I, _LL, _LL, _P, _P, _P,
                               _P, _P, _P, _P, _P, _P, _P, _LL, _LL, _I, _I,
                               _I, _I, _I, _P),
    "vtm_deblock_luma_ver_delta": (_P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P,
                                   _I, _P),
    "vtm_sao_apply": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "vtm_sao_apply_ext": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "vtm_alf_classify": (_P, _I, _I, _P, _P, _P, _P, _I, _P, _P, _P, _I, _I,
                         _I, _P, _P, _P),
    "vtm_alf_filter": (_P, _I, _I, _P, _P, _I, _P, _P, _I, _I, _I, _P, _P),
    "vtm_ccalf_filter": (_P, _I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P,
                         _P),
    "vtm_mc_tiles": (_P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                     _I, _P, _P),
    "vtm_dmvr_search": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P),
    "vtm_fir_blocks": (_I, _P, _P, _I, _P, _P),
    "vtm_bdof_blend": (_P, _P, _I, _I, _I, _I, _P, _P),
    "vtm_satd_batch": (_P, _P, _LL, _I, _I, _P),
    "vtm_rmd_angular": (_P, _I, _I, _P, _P, _I, _P, _I, _I, _I, _P, _I, _P),
    "vtm_rmd_mip": (_P, _I, _I, _P, _P, _I, _P, _I, _I, _I, _I, _P, _I, _P),
    "vtm_rmd_reduce": (_P, _I, _I, _I, _P, _P),
    "vtm_inv_transform": (_P, _P, _P, _P, _LL, _I, _I, _I, _P),
    "vtm_inv_transform_s8": (_P, _P, _P, _P, _LL, _I, _I, _I, _P),
    "vtm_recon_sse": (_P, _P, _P, _P, _P, _LL, _P),
}
KERNELS = tuple(_SIGNATURES)

_lock = threading.Lock()
_lib = None
_launches = dict.fromkeys(KERNELS, 0)


def sources() -> list[str]:
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def _stale() -> bool:
    if not os.path.exists(LIB_PATH):
        return True
    built = os.path.getmtime(LIB_PATH)
    return any(os.path.getmtime(s) > built for s in sources())


def build(force: bool = False, ptxas_verbose: bool = False) -> str:
    """Compile the library if it is missing or stale (or `force`); returns
    nvcc's diagnostics.  Raises with nvcc's stderr when the build fails."""
    if not (force or _stale()):
        return ""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (needed to build the CUDA kernels)")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    verbose = ("-Xptxas", "-v") if ptxas_verbose else ()
    jobs = []
    for src in (s for s in sources() if s.endswith(".cu")):
        obj = os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{tag}.o")
        cmd = [nvcc, *NVCC_FLAGS, *verbose, "-c", "-o", obj, src]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    diag, failed = [], []
    for cmd, _, proc in jobs:
        _, err = proc.communicate()
        diag.append(err)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{err}")
    objs = [obj for _, obj, _ in jobs]
    try:
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = f"{LIB_PATH}.{tag}"
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({res.returncode}): {' '.join(cmd)}\n{res.stderr}")
        os.replace(tmp, LIB_PATH)
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    return "".join(diag)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first where needed."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(LIB_PATH)
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            lib.vtm_error_string.argtypes = [ctypes.c_int]
            lib.vtm_error_string.restype = ctypes.c_char_p
            lib.vtm_rmd_config.argtypes = [_I, _I, _P]
            lib.vtm_rmd_config.restype = ctypes.c_int
            lib.vtm_deblock_config.argtypes = [_P]
            lib.vtm_deblock_config.restype = ctypes.c_int
            _lib = lib
        return _lib


def launch(name: str, device: torch.device, *args) -> None:
    """Call entry point `name` on `device`'s current stream (appended as the
    last argument); raise if the launch failed, else count it."""
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, name)(*args, stream)
    if err != 0:
        msg = lib.vtm_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
    _launches[name] += 1


def launch_counts() -> dict[str, int]:
    return dict(_launches)


def reset_launch_counts() -> None:
    for k in _launches:
        _launches[k] = 0


def check(t: torch.Tensor, name: str, dtype: torch.dtype, device: torch.device,
          shape: tuple | None = None) -> None:
    """Raise unless `t` is what a kernel takes."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
