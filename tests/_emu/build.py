"""Build the port's CUDA sources for the CPU, to check kernel logic
without a card.

    python tests/_emu/build.py OUT_DIR [file.cu ...]

Each vtm_tpu_torch/csrc/*.cu (all of them by default) is rewritten into C++ for the
stub `cuda_runtime.h` beside this file: `kernel<<<grid, block, smem,
stream>>>(args)` becomes `emu_launch(kernel, grid, block, smem, args)`,
which runs every block in turn with one std::thread per CUDA thread and a
std::barrier for __syncthreads().  g++ (C++20, no FP contraction) links
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
    return src.replace("extern __shared__ int sm[];", "")


def build(out_dir: str, names=None) -> str:
    os.makedirs(out_dir, exist_ok=True)
    names = names or sorted(f for f in os.listdir(CSRC) if f.endswith(".cu"))
    gen = os.path.join(out_dir, "src")
    os.makedirs(gen, exist_ok=True)
    for f in os.listdir(CSRC):
        with open(os.path.join(CSRC, f)) as fh:
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
