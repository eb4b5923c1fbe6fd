"""The readers of the program's own records (vvcbench/progtrace.py) on a
synthetic run: self times, timers, counters, the wait and the device time
under the inter spans, each per picture of the window; spans outside the
window left out; None where the program keeps no records or the run has no
device trace."""

import sys
from types import SimpleNamespace

import pytest

from vvcbench import devtrace, manifest
from vvcbench.record import Run

MS = 1_000_000
TID = 7  # the decoding thread's id in the profiler


def span(name, start, end, parent=None, cpu=None, timers=None, counters=None):
    return SimpleNamespace(name=name, start=start * MS, end=end * MS, parent=parent,
                           cpu=None if cpu is None else cpu * MS,
                           timers={k: [n, ms * MS] for k, (n, ms) in (timers or {}).items()},
                           counters=counters or {})


def records():
    """Two pictures in a window [100, 400] ms, one span before it."""
    out = [span("slice", 50, 90, cpu=40)]  # before the window
    for p, t0 in enumerate((100, 250)):
        sl = span("slice", t0, t0 + 100, cpu=60,
                  timers={"parse": (10, 20), "mv": (10, 5)},
                  counters={"h2d_copies": 1, "h2d_bytes": 100})
        rec = span("recon", t0 + 40, t0 + 90, parent=sl,
                   timers={"recon.intra": (3, 6), "recon.inter": (4, 8)})
        mc = span("inter.mc", t0 + 45, t0 + 55, parent=rec,
                  counters={"h2d_copies": 2, "h2d_bytes": 1000, "d2h_copies": 1,
                            "kernel_launches": 2})
        plan = span("inter.plan", t0 + 41, t0 + 44, parent=rec)
        dmvr = span("inter.dmvr", t0 + 60, t0 + 70, parent=rec,
                    counters={"kernel_launches": 3})
        fin = span("finish", t0 + 100, t0 + 140, cpu=30)
        maps = [span(f"maps.{k}", t0 + 101 + 3 * i, t0 + 103 + 3 * i, parent=fin)
                for i, k in enumerate(("deblock", "sao", "alf"))]
        up = span("chain.upload", t0 + 110, t0 + 115, parent=fin,
                  counters={"h2d_copies": 40, "h2d_bytes": 10_000})
        fetch = span("fetch", t0 + 141, t0 + 144, cpu=1, counters={"d2h_copies": 1})
        hsh = span("hash", t0 + 144, t0 + 146, cpu=2)
        out += [sl, plan, rec, mc, dmvr, fin, *maps, up, fetch, hsh]
    return out


# a run on the card: a chain kernel, launched in picture 2's slice, under no inter span
CHAIN_OP = (("void alf_filter_kernel(int*)", 300 * MS, 301 * MS),)
CHAIN_LAUNCH = ((252 * MS, TID),)


def run_of(recs, device_ops=CHAIN_OP, launched=CHAIN_LAUNCH):
    r = Run(workload="ra-classD-decode", config={}, traffic={}, seed=1, seconds=1.0,
            traced=True, device="cuda")
    r.pictures = 2
    r.trace = devtrace.Trace(window=(100 * MS, 400 * MS), device_ops=list(device_ops),
                             spans=[("stream", 100 * MS, 400 * MS, TID),
                                    ("slice", 100 * MS, 200 * MS, TID)],
                             launched=list(launched))
    return r


@pytest.fixture
def program(monkeypatch):
    from vtm_tpu_torch import trace

    recs = records()
    monkeypatch.setattr(trace, "records", lambda lo=None, hi=None: list(recs))
    return recs


def read(name, run):
    return manifest.reader(name)(run)


EXPECTED = {
    "parse_ms_per_picture.decode": 20.0,
    "mv_ms_per_picture.decode": 5.0,
    "intra_ms_per_picture.decode": 6.0,
    # inter.plan 3 + inter.mc 10 + inter.dmvr 10 + recon.inter 8
    "inter_ms_per_picture.decode": 31.0,
    "maps_ms_per_picture.decode": 6.0,
    "upload_ms_per_picture.chain": 5.0,
    "output_ms_per_picture.decode": 5.0,
    # (100 - 60) + (40 - 30) + (3 - 1) + (2 - 2)
    "wait_ms_per_picture.decode": 52.0,
    "h2d_copies_per_picture.decode": 43.0,
    "h2d_bytes_per_picture.decode": 11_100.0,
    "d2h_copies_per_picture.decode": 2.0,
    "kernel_launches_per_picture.decode": 5.0,
}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_on_synthetic_records(program, name):
    assert read(name, run_of(program)) == pytest.approx(EXPECTED[name])


def test_every_new_reader_is_in_the_manifest():
    names = {m["name"] for m in manifest.load()["per_layer"]}
    assert set(EXPECTED) | {"kernel_ms_per_picture.inter_batches"} <= names


def test_device_time_under_inter_spans(program):
    ms = lambda a, b: (a * MS, b * MS)  # noqa: E731
    ops = [("void mc_tiles_kernel<4>(int*)", *ms(146, 148)),       # under inter.mc
           ("Memcpy DtoH (Device -> Pageable)", *ms(147, 149)),    # overlaps it
           ("aten::copy_ kernel", *ms(162, 165)),                  # under inter.dmvr
           ("void alf_filter_kernel(int*)", *ms(300, 301)),        # under finish
           ("renamed_kernel", *ms(296, 297)),                      # inter.mc, picture 2
           ("void sao_kernel(int*)", *ms(150, 152))]               # another thread
    launched = [(145.5 * MS, TID), (146 * MS, TID), (161 * MS, TID), (252 * MS, TID),
                (295.5 * MS, TID), (146 * MS, TID + 1)]
    run = run_of(program, ops, launched)
    # (148 - 146 + 1) + 3 + 1 over 2 pictures
    assert read("kernel_ms_per_picture.inter_batches", run) == pytest.approx(3.5)


def test_none_without_records(monkeypatch, program):
    run = run_of(program)
    run.trace = None
    for name in [*EXPECTED, "kernel_ms_per_picture.inter_batches"]:
        assert read(name, run) is None, name
    # a run with no device trace, as one on the CPU
    run = run_of(program, device_ops=(), launched=())
    for name in [*EXPECTED, "kernel_ms_per_picture.inter_batches"]:
        assert read(name, run) is None, name
    # a program without vtm_tpu_torch/trace.py, as an older commit is
    import vtm_tpu_torch

    monkeypatch.delattr(vtm_tpu_torch, "trace")
    monkeypatch.setitem(sys.modules, "vtm_tpu_torch.trace", None)
    run = run_of(program)
    for name in [*EXPECTED, "kernel_ms_per_picture.inter_batches"]:
        assert read(name, run) is None, name


def test_none_where_records_sum_to_zero(monkeypatch):
    from vtm_tpu_torch import trace

    recs = [span("slice", 100, 150, cpu=50), span("finish", 150, 160, cpu=10)]
    monkeypatch.setattr(trace, "records", lambda lo=None, hi=None: list(recs))
    run = run_of(recs)
    for name in [*EXPECTED, "kernel_ms_per_picture.inter_batches"]:
        assert read(name, run) is None, name
