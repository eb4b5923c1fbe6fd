"""Whole runs of the RA decode cell on the CPU, past the harness's look for
a card: sound runs are correct, and the control and every planted fault
are not.  Then the run's exits: without a card, in a directory that holds
only the benchmark, and with jax loaded."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from vvcbench import card, harness, manifest, plants

CELL = "ra-classD-decode"
SEED = 2**31 + 12345  # wider than 32 signed bits, as the runs' seeds are


@pytest.fixture(scope="module")
def man():
    return manifest.load()


@pytest.mark.parametrize("traced", [False, True], ids=["trace0", "trace1"])
def test_sound_run_is_correct(man, traced):
    res = harness.run_cell(man, CELL, SEED, 0.1, traced, device="cpu")
    assert res["correct"] is True
    assert res["attempted"] == 8 and res["failed"] == 0
    assert res["checks"] == {"pictures_wrong": {"value": 0, "limit": 0}}
    assert list(res)[-1] == "checks"
    want = {m["name"] for m in manifest.metrics_of(man, CELL, traced)}
    if traced:
        # the CPU has no device trace: only the host spans read
        assert set(res["metrics"]) == {"picture_ms_p95.decode", "slice_ms_per_picture.decode",
                                       "finish_ms_per_picture.decode"}
        assert set(res["metrics"]) < want
        assert "breakdown" in res and res["device"]["window_s"] > 0
    else:
        assert set(res["metrics"]) == want
    for m in res["metrics"].values():
        assert m["value"] > 0


@pytest.mark.parametrize("plant", plants.PLANTS)
def test_control_and_faults_are_caught(man, plant):
    res = harness.run_cell(man, CELL, SEED, 0.1, False, device="cpu", plant=plant)
    assert res["correct"] is False
    assert res["failed"] > 0
    assert res["checks"]["pictures_wrong"]["value"] > res["checks"]["pictures_wrong"]["limit"]


def test_plants_are_undone(man):
    from vtm_tpu_torch.decoder.declib import Decoder
    from vtm_tpu_torch.ops import filter_chain as FC

    before = (FC.chain_body, Decoder.finish_picture, Decoder.flush, Decoder._decode_slice)
    for p in plants.PLANTS:
        with plants.planted(p):
            pass
    harness.run_cell(man, CELL, SEED, 0.1, True, device="cpu")
    assert (FC.chain_body, Decoder.finish_picture, Decoder.flush,
            Decoder._decode_slice) == before


def test_seed_orders_streams_only():
    from vvcbench import traffic

    a, b = traffic.input_order(SEED, 5), traffic.input_order(SEED + 1, 5)
    ca, cb = [next(a) for _ in range(10)], [next(b) for _ in range(10)]
    assert sorted(ca[:5]) == sorted(cb[:5]) == sorted(ca[5:]) == list(range(5))
    again = traffic.input_order(SEED, 5)
    assert [next(again) for _ in range(10)] == ca


def test_forbidden_modules_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "vtm_tpu_torch.ops", sys)
    monkeypatch.setitem(sys.modules, "jaxy", sys)
    assert not {"vtm_tpu_torch.ops", "jaxy"} & set(card.forbidden_modules())
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    monkeypatch.setitem(sys.modules, "vtm_tpu.ops", sys)
    assert {"jax.numpy", "vtm_tpu.ops"} <= set(card.forbidden_modules())


def test_no_forbidden_module_after_a_run():
    code = ("import sys; sys.path.insert(0, sys.argv[1]);"
            "from vvcbench import card, harness, manifest;"
            f"r = harness.run_cell(manifest.load(), {CELL!r}, {SEED}, 0.1, False, device='cpu');"
            "assert r['correct'];"
            "print(card.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code, manifest.ROOT], capture_output=True,
                         text=True, cwd=manifest.ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_exits_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure")
    out = subprocess.run([sys.executable, "vvcbench/run.py", "--workload", CELL, "--seed",
                          str(SEED), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=manifest.ROOT, timeout=600)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "torch.cuda.is_available() is False" in out.stderr


def test_fails_with_only_the_benchmark(tmp_path):
    """A directory that holds BENCHMARK.json and the files under `paths`
    alone: the program is missing and the run fails."""
    shutil.copy(manifest.MANIFEST, tmp_path / "BENCHMARK.json")
    for p in manifest.load()["paths"]:
        shutil.copytree(os.path.join(manifest.ROOT, p), tmp_path / p,
                        ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, json; sys.path.insert(0, sys.argv[1]);"
            "from vvcbench import harness, manifest;"
            f"print(json.dumps(harness.run_cell(manifest.load(), {CELL!r}, 1, 0.1, False,"
            " device='cpu')))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)], capture_output=True,
                         text=True, cwd=tmp_path, timeout=600, env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "vtm_tpu_torch" in out.stderr


def test_result_line_is_json_last(man, capsys):
    res = harness.run_cell(man, CELL, SEED, 0.1, False, device="cpu")
    harness.emit(res)
    cap = capsys.readouterr()
    assert json.loads(cap.out.strip().splitlines()[-1]) == res
    last = cap.err.strip().splitlines()[-1]
    assert last.startswith("[cpu x1, power limit none] check pictures_wrong: 0 (limit 0)")
