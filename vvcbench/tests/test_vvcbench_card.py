"""On the card: each cell as the benchmark runs it (a short window) is
correct and names the card, and with the control in place is not.

    python3 -m pytest -m cuda vvcbench/tests -rs
"""

import json
import subprocess
import sys

import pytest

from vvcbench import manifest

CELLS = [w["name"] for w in manifest.load()["workloads"]]


@pytest.fixture
def cuda_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.cuda.get_device_name(0)


def run(cell: str, seed: int, *extra: str) -> dict:
    out = subprocess.run([sys.executable, "vvcbench/run.py", "--workload", cell, "--seed",
                          str(seed), "--seconds", "2", "--trace", "0", *extra],
                         capture_output=True, text=True, cwd=manifest.ROOT, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct_on_the_card(cuda_card, cell):
    res = run(cell, 2**31 + 101)
    assert res["correct"] is True and res["failed"] == 0
    assert res["device"]["platform"] == "gpu" and res["device"]["kind"] == cuda_card
    assert res["device"]["count"] == 1 and res["device"]["memory_peak_bytes"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_on_the_card(cuda_card, cell):
    res = run(cell, 2**31 + 102, "--plant", "alf_off")
    assert res["correct"] is False
    assert res["checks"]["pictures_wrong"]["value"] > 0
