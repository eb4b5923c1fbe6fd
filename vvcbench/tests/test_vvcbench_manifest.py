"""BENCHMARK.json against the benchmark's contract, and every name it gives
found as a file."""

import json
import os
import re

import pytest

from vvcbench import manifest

MAN = manifest.load()
METRICS = MAN["end_to_end"] + MAN["per_layer"]
ONE_LINE = re.compile(r"[^\t\r\n]{1,200}")
PATH_RE = re.compile(r"[A-Za-z0-9_./-]{1,200}")


def test_keys_and_command():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert 1 <= len(MAN["paths"]) <= 16
    for p in MAN["paths"]:
        assert PATH_RE.fullmatch(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    assert 1 <= len(MAN["command"]) <= 32
    for word in MAN["command"]:
        assert ONE_LINE.fullmatch(word) and not word.startswith("/") and ".." not in word
        if os.path.exists(os.path.join(manifest.ROOT, word)):
            assert any(word.startswith(p + "/") for p in MAN["paths"]), word
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51
    assert len(json.dumps(MAN)) <= 64 * 1024


@pytest.mark.parametrize("entry", [*MAN["configs"], *MAN["workloads"], *METRICS],
                         ids=lambda e: e["name"])
def test_names(entry):
    assert manifest.NAME_RE.fullmatch(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert manifest.NAME_RE.fullmatch(entry[key])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert ONE_LINE.fullmatch(entry[key])


def test_names_unique():
    for group in (MAN["configs"], MAN["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_metric(m):
    assert manifest.UNIT_RE.fullmatch(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert os.path.exists(manifest.metric_path(m["name"])), m["name"]
    assert callable(manifest.reader(m["name"]))
    cells = {w["name"] for w in MAN["workloads"]}
    assert set(m.get("workloads", cells)) <= cells
    if m in MAN["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        moved = {e["name"]: e for e in MAN["end_to_end"]}[m["moves"]]
        # every cell the metric lists reports the end-to-end metric it moves
        assert set(m.get("workloads", cells)) <= set(moved.get("workloads", cells))
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_setup_s():
    setup = {e["name"]: e for e in MAN["end_to_end"]}["setup_s"]
    assert setup["unit"] == "s" and setup["better"] == "lower" and setup["bound"] <= 0.25


@pytest.mark.parametrize("c", MAN["configs"], ids=lambda c: c["name"])
def test_config(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert c["file"].startswith(tuple(p + "/" for p in MAN["paths"]))
    cfg = manifest.config(MAN, c["name"])
    assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
    assert set(c["reduced"]) == set(cfg["reduced"]) and len(c["reduced"]) <= 16
    for key in c["reduced"]:
        assert manifest.NAME_RE.fullmatch(key)
    for s in cfg["streams"]:
        for key in ("bitstream", "reference"):
            assert os.path.exists(os.path.join(manifest.HERE, s[key]))
    assert any(w["config"] == c["name"] for w in MAN["workloads"])
    assert len({m["file"] for m in MAN["configs"]}) == len(MAN["configs"])


@pytest.mark.parametrize("w", MAN["workloads"], ids=lambda w: w["name"])
def test_cell(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] in (1, 4)
    manifest.config_entry(MAN, w["config"])
    mix = manifest.traffic(w["traffic"])
    assert os.path.exists(os.path.join(manifest.HERE, "runners", f"{mix['runner']}.py"))
    e2e = [m["name"] for m in manifest.metrics_of(MAN, w["name"], False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert manifest.metrics_of(MAN, w["name"], True)


def test_four_chip_cells():
    fours = sum(w["chips"] == 4 for w in MAN["workloads"])
    assert fours <= max(1, len(MAN["workloads"]) // 4)


def test_files_named_from_names():
    name_chars = re.compile(r"[A-Za-z0-9_.\-/]+")
    for p in MAN["paths"]:
        for dirpath, dirs, files in os.walk(os.path.join(manifest.ROOT, p)):
            dirs[:] = [d for d in dirs if d != "__pycache__"]
            for f in files:
                rel = os.path.relpath(os.path.join(dirpath, f), manifest.ROOT)
                assert name_chars.fullmatch(rel), rel
