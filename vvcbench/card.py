"""The card a run uses, the process's start, and the modules it may not load."""

from __future__ import annotations

import os
import subprocess
import sys
import time

FORBIDDEN = ("jax", "jaxlib", "flax", "vtm_tpu")


class NoCard(RuntimeError):
    """The run asks for more CUDA devices than the machine has."""


def require(chips: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is False: the benchmark runs on "
                     "the card only")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell asks for {chips} CUDA devices, the machine has "
                     f"{torch.cuda.device_count()}")


def power_limit() -> str:
    """nvidia-smi's power limit of card 0, as it prints it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"power limit not read ({type(e).__name__})"
    return out.stdout.strip() or f"power limit not read (rc {out.returncode})"


def describe(device: str, chips: int) -> dict:
    """Name, count and power limit of the card, or of the CPU in tests."""
    if device == "cpu":
        return dict(platform="cpu", kind="cpu", count=1, power_limit="none")
    import torch

    return dict(platform="gpu", kind=torch.cuda.get_device_name(0), count=chips,
                power_limit=power_limit())


def since_process_start() -> float:
    """Seconds since this process started (the kernel's start time, on the
    boot clock it counts from)."""
    with open("/proc/self/stat") as f:
        stat = f.read()
    # fields after the command name, which may hold spaces: starttime is 22nd
    start_ticks = int(stat.rsplit(")", 1)[1].split()[19])
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is jax's, jaxlib's, flax's or the
    jax package's (compared whole: vtm_tpu_torch is not vtm_tpu)."""
    return sorted(m for m in list(sys.modules) if m.split(".", 1)[0] in FORBIDDEN)
