"""BENCHMARK.json and the files its names lead to."""

from __future__ import annotations

import importlib.util
import json
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
MANIFEST = os.path.join(ROOT, "BENCHMARK.json")

NAME_RE = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT_RE = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


def load(path: str = MANIFEST) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(man: dict, name: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_entry(man: dict, name: str) -> dict:
    for c in man["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def config(man: dict, name: str) -> dict:
    """The configuration's file, as the manifest names it."""
    return read_json(os.path.join(ROOT, config_entry(man, name)["file"]))


def traffic_path(name: str) -> str:
    return os.path.join(HERE, "traffic", f"{name}.json")


def traffic(name: str) -> dict:
    return read_json(traffic_path(name))


def metric_path(name: str) -> str:
    return os.path.join(HERE, "metrics", f"{name}.py")


def reader(name: str):
    """The `read(run)` function of metrics/<name>.py."""
    spec = importlib.util.spec_from_file_location(
        f"vvcbench_metric_{re.sub(r'[^A-Za-z0-9_]', '_', name)}", metric_path(name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def metrics_of(man: dict, workload: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics, or with `trace` its per-layer ones."""
    return [m for m in man["per_layer" if trace else "end_to_end"] if applies(m, workload)]
