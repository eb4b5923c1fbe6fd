"""Native (C) runtime components of the port: the CABAC engine with its
residual decoder and bit estimator (cabac.c), the batched TCQ scan
(tcq.c) and the dependent-quantisation trellis (depquant.c).

Each is a CPython extension built from its source here with the system C
compiler at first use, into the package's `_build/` directory, and loaded
under a module name of its own (`_vtm_torch_cabac`, `_vtm_torch_tcq`,
`_vtm_torch_depquant`).  A build that fails raises: there is no silent
switch to the Python engines.
"""

from __future__ import annotations

import importlib.util
import os
import subprocess
import sysconfig
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
_lock = threading.Lock()
_loaded: dict = {}


def _build(name: str, source: str) -> str:
    """Path of the extension `name` built from `source`, compiled first
    where it is missing or older than the source."""
    tag = sysconfig.get_config_var("SOABI") or "cpython"
    so = os.path.join(BUILD_DIR, f"{name}.{tag}.so")
    src = os.path.join(_DIR, source)
    if not os.path.exists(so) or os.path.getmtime(so) < os.path.getmtime(src):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        cc = os.environ.get("CC", "cc")
        inc = sysconfig.get_paths()["include"]
        cmd = [cc, "-O3", "-shared", "-fPIC", f"-I{inc}", src, "-o", tmp]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"building {name} failed ({res.returncode}): "
                               f"{' '.join(cmd)}\n{res.stderr}")
        os.replace(tmp, so)
    return so


def _load(name: str, source: str):
    with _lock:
        mod = _loaded.get(name)
        if mod is None:
            spec = importlib.util.spec_from_file_location(name, _build(name, source))
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            _loaded[name] = mod
        return mod


def load_cabac():
    """The CABAC engine module (NativeCabac, rc_block, rc_est)."""
    return _load("_vtm_torch_cabac", "cabac.c")


def load_tcq():
    """The batched TCQ scan module, the native twin of encoder/tcq_scan.py."""
    return _load("_vtm_torch_tcq", "tcq.c")


def load_depquant():
    """The dependent-quantisation trellis module."""
    return _load("_vtm_torch_depquant", "depquant.c")
