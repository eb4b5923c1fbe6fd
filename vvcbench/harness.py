"""One run of one cell: set-up, the window, the reference check, the result.

    python3 vvcbench/run.py --workload NAME --seed N --seconds S --trace 0|1

The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
`--trace 1` its per-layer ones), `device`, with `--trace 1` `breakdown`,
the card's `power_limit`, and last `checks`: each number compared with the
reference beside its limit.  The checks are also the last lines of
standard error.  Without a CUDA device, with fewer than the cell asks for,
or with jax or the jax package loaded once the window has closed, the run
prints no result and exits non-zero.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys

from vvcbench import card, devtrace, manifest, plants
from vvcbench.record import Run


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="vvcbench/run.py", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--plant", choices=plants.PLANTS, default=None,
                   help="run with the control or a planted fault in place "
                        "(never in a benchmark run)")
    return p.parse_args(argv)


def run_cell(man: dict, workload: str, seed: int, seconds: float, traced: bool,
             device: str = "cuda", plant: str | None = None) -> dict:
    """The result of one run on `device` ("cpu" only in the harness's tests,
    which skip the look for a card)."""
    cell = manifest.cell(man, workload)
    card_info = card.describe(device, cell["chips"])
    mix = manifest.traffic(cell["traffic"])
    r = Run(workload=workload, config=manifest.config(man, cell["config"]),
            traffic=mix, seed=seed, seconds=seconds, traced=traced, device=device)
    runner = importlib.import_module(f"vvcbench.runners.{mix['runner']}")
    with plants.planted(plant):
        runner.run(r)
    metrics = {}
    for m in manifest.metrics_of(man, workload, traced):
        value = manifest.reader(m["name"])(r)
        if value is None:
            if not traced:
                raise RuntimeError(f"end-to-end metric {m['name']} has no reading")
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {k: card_info[k] for k in ("platform", "kind", "count")}
    dev["memory_peak_bytes"] = r.memory_peak_bytes
    out = {"correct": r.correct, "attempted": r.attempted, "failed": r.failed,
           "metrics": metrics, "device": dev}
    if traced:
        busy = devtrace.busy_ns((s, e) for _, s, e in r.trace.device_ops)
        lo, hi = r.trace.window
        dev["busy_s"] = busy / 1e9
        dev["window_s"] = (hi - lo) / 1e9
        out["breakdown"] = devtrace.breakdown(r.trace)
    out["power_limit"] = card_info["power_limit"]
    if plant is not None:
        out["plant"] = plant
    out["checks"] = r.checks
    return out


def card_tag(res: dict) -> str:
    d = res["device"]
    return f"[{d['kind']} x{d['count']}, power limit {res['power_limit']}]"


def emit(res: dict) -> None:
    tag = card_tag(res)
    print(f"{tag} correct={res['correct']} attempted={res['attempted']} "
          f"failed={res['failed']}", file=sys.stderr)
    for name, c in res["checks"].items():
        print(f"{tag} check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)


def main(argv) -> int:
    args = parse(argv)
    man = manifest.load()
    cell = manifest.cell(man, args.workload)
    try:
        card.require(cell["chips"])
    except card.NoCard as e:
        print(f"vvcbench: {e}", file=sys.stderr)
        return 2
    res = run_cell(man, args.workload, args.seed, args.seconds, bool(args.trace),
                   plant=args.plant)
    bad = card.forbidden_modules()
    if bad:
        print(f"vvcbench: forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    emit(res)
    return 0
