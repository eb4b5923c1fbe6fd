"""Build the port's CUDA sources for the CPU, to check kernel logic
without a card.

    python tests/_emu/build.py OUT_DIR [file.cu ...]

Each vtm_tpu_torch/csrc/*.cu (all of them by default) is rewritten into C++ for the
stub `cuda_runtime.h` beside this file: `kernel<<<grid, block, smem,
stream>>>(args)` becomes `emu_launch(kernel, grid, block, smem, args)`,
which runs every block in turn with one std::thread per CUDA thread and a
std::barrier for __syncthreads(); `extern __shared__ T name[];` becomes a
pointer of that type to one global buffer; inline PTX (`asm volatile`) is
dropped, so a kernel that uses it gives wrong results here and is not
tested so.  The int8 tensor-core products and asynchronous copies of
csrc/tc.cuh are inline PTX: its twin here (tc.cuh: a warp-collective
mma_k32 through the stub's exchange slots, cp_async as a copy) takes its
place in the build, and mma_probe.cu, also here, exposes one product to
the tests (`emu_mma_k32`).  g++ (C++20, no FP contraction) links
the result into OUT_DIR/libvtm_emu.so with the same C entry points as the
real library; `load` returns it with their ctypes argument types, to call
on CPU tensors' data_ptr()s and hold against the plain torch versions.
Slow (a thread per CUDA thread): use a few blocks.  Test support only:
the package never imports it.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(os.path.dirname(HERE)), "vtm_tpu_torch", "csrc")


def _launch_config(cfg: str) -> str:
    """grid, block, smem of a <<<...>>> list (smem 0 when absent)."""
    parts, depth, cur = [], 0, ""
    for ch in cfg:
        if ch == "," and depth == 0:
            parts.append(cur)
            cur = ""
            continue
        depth += ch in "(<["
        depth -= ch in ")>]"
        cur += ch
    parts.append(cur)
    parts = (parts + ["0", "0"])[:3]
    return ", ".join(p.strip() for p in parts)


def translate(src: str) -> str:
    src = re.sub(r"(\w+(?:<[^<>]*>)?)\s*<<<(.*?)>>>\s*\(",
                 lambda m: f"emu_launch({m.group(1)}, {_launch_config(m.group(2))}, ",
                 src, flags=re.S)
    # the dynamic shared buffer, under each kernel's own name and type
    src = re.sub(r"extern __shared__ (?:__align__\(\d+\) )?(\w+) (\w+)\[\];",
                 r"\1* const \2 = reinterpret_cast<\1*>(emu_sm_buf);", src)
    # inline PTX has no host meaning: a kernel that uses it is not run here
    return src.replace("asm volatile(", "emu_asm(")


def build(out_dir: str, names=None) -> str:
    os.makedirs(out_dir, exist_ok=True)
    names = names or sorted(f for f in os.listdir(CSRC) if f.endswith(".cu"))
    gen = os.path.join(out_dir, "src")
    os.makedirs(gen, exist_ok=True)
    # the csrc sources, a header with a twin here (tc.cuh) replaced by it,
    # and this directory's own test-support sources (mma_probe.cu)
    files = {f: os.path.join(CSRC, f) for f in os.listdir(CSRC)}
    files.update({f: os.path.join(HERE, f) for f in os.listdir(HERE)
                  if f.endswith(".cu") or (f.endswith(".cuh") and f in files)})
    for f, path in files.items():
        with open(path) as fh:
            text = translate(fh.read())
        with open(os.path.join(gen, f), "w") as fh:
            fh.write(text)
    lib = os.path.join(out_dir, "libvtm_emu.so")
    cmd = ["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
           "-x", "c++", f"-I{HERE}", "-o", lib,
           *(os.path.join(gen, n) for n in names), "-lpthread"]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed:\n{res.stderr}")
    return lib


def load(out_dir: str, names=None) -> ctypes.CDLL:
    """Build, then load the library with the entry points' argument types
    (those of vtm_tpu_torch.kernels)."""
    from vtm_tpu_torch import kernels

    lib = ctypes.CDLL(build(out_dir, names))
    for name, argtypes in kernels._SIGNATURES.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
    return lib


if __name__ == "__main__":
    print(build(sys.argv[1], sys.argv[2:] or None))
