"""The decode's spans, timers and counters (vtm_tpu_torch/trace.py) on the
CPU.

(a) with no profiler recording, nothing is recorded and no profiler range
    is entered: each call returns the shared no-op;
(b) under a CPU torch.profiler session: nesting, parents, timers, counters
    and the self-time arithmetic; the picture ids of two decoders never
    meet; every `vtm.*` range of the profiler starts between the
    recorder's last clock reading and its start of the same span, the
    median within 100 us of that start; a
    new session clears the last one's records; the cap counts what it
    drops;
(c) a traced decode of a small stream has `slice`, `finish` and `fetch`
    spans for every picture, counters that add up per picture, and the
    same hashes as an untraced one.
"""

import bisect
import os
import time

import pytest
from torch.profiler import ProfilerActivity, profile

from vtm_tpu_torch import trace
from vtm_tpu_torch.decoder.declib import Decoder

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STREAM = "ra_full_small208_qp32"  # 3 pictures: intra, inter, DMVR


def read(name):
    with open(os.path.join(ROOT, "testdata", f"{name}.bit"), "rb") as f:
        return f.read()


def cpu_profile():
    """A CPU profiler session whose first span clears the last session's
    records: a picture begun with tracing off marks them stale."""
    assert trace.new_picture(0) is None
    return profile(activities=[ProfilerActivity.CPU])


def test_off_records_nothing_and_enters_no_range(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a profiler range was entered with tracing off")

    monkeypatch.setattr(trace, "record_function", refuse)
    monkeypatch.setattr(trace, "Span", refuse)
    trace.clear()
    assert trace.span("slice") is trace.NOOP
    assert trace.span("finish", pic=(0, 0)) is trace.NOOP
    assert trace.timer("parse") is trace.NOOP
    assert trace.count("h2d_copies", 5) is None
    assert trace.new_picture(3) is None
    dec = Decoder(device="cpu")
    dec.decode_stream(read(STREAM))
    assert all(h.ok for h in dec.hash_results)
    assert trace.records() == [] and trace.dropped() == 0
    assert all(p.trace_id is None for p in dec.output)


def test_nesting_timers_counters_and_self_time():
    with cpu_profile():
        pic = trace.new_picture(7)
        other = (-1, 99)
        with trace.span("a") as a:
            with trace.span("b") as b:
                with trace.timer("t"):
                    time.sleep(0.002)
                trace.count("c", 3)
                trace.count("c")
            with trace.timer("t"):
                time.sleep(0.001)
            with trace.span("d", pic=other) as d:
                with trace.span("e") as e:
                    trace.count("c", 10)
    assert [r.name for r in trace.records()] == ["a", "b", "d", "e"]
    assert a.parent is None and b.parent is a and d.parent is a and e.parent is d
    assert a.pic == b.pic == pic and d.pic == e.pic == other
    assert a.cpu is not None and 0 <= a.cpu <= a.end - a.start
    assert b.cpu is None and d.cpu is None
    assert b.timers == {"t": [1, b.timers["t"][1]]} and b.timers["t"][1] >= 2_000_000
    assert a.timers["t"][0] == 1 and a.timers["t"][1] >= 1_000_000
    assert b.counters == {"c": 4} and e.counters == {"c": 10} and a.counters == {}
    for r in (a, b, d, e):
        assert r.start <= r.end
    assert b.start >= a.start and b.end <= d.start and e.end <= d.end <= a.end
    own = trace.self_ns(trace.records())
    dur = {r.name: r.end - r.start for r in trace.records()}
    assert own[0] == dur["a"] - dur["b"] - dur["d"] - a.timers["t"][1]
    assert own[1] == dur["b"] - b.timers["t"][1]
    assert own[2] == dur["d"] - dur["e"] and own[3] == dur["e"]
    s = trace.summary()
    assert set(s) == {pic, other}
    assert s[pic]["counters"] == {"c": 4} and s[other]["counters"] == {"c": 10}
    assert s[pic]["timers"]["t"][0] == 2
    assert s[pic]["self_ms"]["a"] == pytest.approx(own[0] / 1e6)
    assert s[pic]["wall_ms"] == pytest.approx(dur["a"] / 1e6)
    assert s[other]["wall_ms"] == 0.0  # d has a parent
    inside = trace.records(b.start, b.end)
    assert [r.name for r in inside] == ["b"]


def test_new_session_clears_and_cap_counts_drops(monkeypatch):
    with cpu_profile():
        with trace.span("old"):
            pass
    assert [r.name for r in trace.records()] == ["old"]
    monkeypatch.setattr(trace, "CAP", 2)
    with cpu_profile():
        for name in ("x", "y", "z"):
            with trace.span(name):
                pass
    assert [r.name for r in trace.records()] == ["x", "y"]
    assert trace.dropped() == 1


def _traced_decode(bits, n=1):
    with cpu_profile() as prof:
        decs = [Decoder(device="cpu") for _ in range(n)]
        for d in decs:
            d.decode_stream(bits)
    return prof, decs


def test_picture_ids_unique_across_decoders():
    _, decs = _traced_decode(read(STREAM), n=2)
    ids = [p.trace_id for d in decs for p in d.output]
    assert len(ids) == 6 and None not in ids and len(set(ids)) == len(ids)
    for d in decs:
        assert [i[1] for i in (p.trace_id for p in d.output)] == [p.poc for p in d.output]
    assert {r.pic for r in trace.records() if r.name in ("slice", "finish")} == set(ids)


def test_profiler_ranges_share_the_recorders_clock():
    # the first profiler range of a process sets up torch's range machinery
    # (about a millisecond): open one before the decode that is measured
    with cpu_profile():
        with trace.span("warm-up"):
            pass
    prof, _ = _traced_decode(read(STREAM))
    evs = sorted((e for e in prof.profiler.kineto_results.events()
                  if e.name().startswith("vtm.")), key=lambda e: e.start_ns())
    recs = sorted(trace.records(), key=lambda r: r.start)
    assert [e.name() for e in evs] == ["vtm." + r.name for r in recs]
    # the profiler stamps a range after the recorder's last clock reading
    # before it (a start or an end) and before the recorder reads the
    # span's start: on one clock, every range starts between the two (20 us
    # for the profiler's clock conversion); a thread preempted in between
    # (several workers share these cores) moves a few stamps by
    # milliseconds, not the median
    reads = sorted([r.start for r in recs] + [r.end for r in recs])
    for r, e in zip(recs, evs):
        i = bisect.bisect_left(reads, r.start)
        before = reads[i - 1] if i else 0
        assert before - 20_000 <= e.start_ns() <= r.start + 20_000, (r.name, e.start_ns() - r.start)
    off = [abs(r.start - e.start_ns()) for r, e in zip(recs, evs)]
    assert sorted(off)[len(off) // 2] < 100_000


def test_traced_decode_has_each_pictures_spans_and_counters():
    bits = read(STREAM)
    plain = Decoder(device="cpu")
    plain.decode_stream(bits)
    _, (dec,) = _traced_decode(bits)
    assert [h.computed for h in dec.hash_results] == [h.computed for h in plain.hash_results]
    assert all(h.ok for h in dec.hash_results)
    recs = trace.records()
    ids = [p.trace_id for p in dec.output]
    for name in ("slice", "finish", "fetch", "hash", "recon", "chain.upload", "chain"):
        assert sorted({r.pic for r in recs if r.name == name}) == sorted(ids), name
    s = trace.summary()
    totals = {}
    for r in recs:
        for k, v in r.counters.items():
            totals[k] = totals.get(k, 0) + v
    per_pic = {}
    for p in s.values():
        for k, v in p["counters"].items():
            per_pic[k] = per_pic.get(k, 0) + v
    assert per_pic == totals
    for p in dec.output:
        c = s[p.trace_id]["counters"]
        plane_bytes = sum(a.nbytes for a in p.planes)
        assert c["h2d_copies"] > 0 and c["h2d_bytes"] >= plane_bytes
        assert c["d2h_copies"] >= 1  # the picture's fetch
        assert s[p.trace_id]["timers"]["parse"][0] > 0
    fetch = [r for r in recs if r.name == "fetch"]
    assert all(r.counters == {"d2h_copies": 1} for r in fetch)
    # the top-level spans: NAL unpacking and parameter sets, slices,
    # the last picture's finish and the output
    assert {r.name for r in recs if r.parent is None} <= {"nal", "slice", "finish", "fetch",
                                                          "hash"}
    # a picture's finish inside the next picture's slice is the finished one's
    for r in recs:
        if r.name == "finish" and r.parent is not None:
            assert r.parent.pic != r.pic
