"""The program's own records of a `--trace 1` run: the spans, timers and
counters that vtm_tpu_torch/trace.py keeps while the profiler records, read
back in the run's process once the window has closed.

Only the spans that lie inside the traced window count.  A span's self time
is its duration less its timers and its children's durations (children
inside the window); its timers add their nanoseconds to the span that was
innermost when they ran.  The device operations launched under a program
span are found as devtrace.under finds them for a harness range: by the
host clock and thread at their launch (`run.trace.launched`), on the
thread that decoded (the harness's own spans name it).

A program without these records (one older than them) gives None here, as
does a run with no device trace (a run on the CPU): the records split a
run on the card, where the device's operations are in the same trace; each
reader then reports nothing.
"""

from __future__ import annotations

import bisect

from vvcbench import devtrace


def records(run) -> list | None:
    """The program's spans inside the traced window, in the order they
    opened, or None."""
    if run.trace is None or not run.trace.device_ops:
        return None
    try:
        from vtm_tpu_torch import trace
    except ImportError:
        return None
    lo, hi = run.trace.window
    recs = [r for r in trace.records() if lo <= r.start and r.end <= hi]
    return recs or None


def self_ns(recs) -> list[int]:
    """Each span's own nanoseconds, in the order of `recs`."""
    pos = {id(r): i for i, r in enumerate(recs)}
    out = [r.end - r.start - sum(ns for _, ns in r.timers.values()) for r in recs]
    for r in recs:
        i = pos.get(id(r.parent))
        if i is not None:
            out[i] -= r.end - r.start
    return out


def _per_picture(run, value: float):
    if not value or value <= 0 or run.pictures == 0:
        return None
    return value / run.pictures


def ms_per_picture(run, spans=(), timers=()):
    """The self time of the spans named in `spans` and the time of the
    timers named in `timers`, in ms per picture of the window."""
    recs = records(run)
    if recs is None:
        return None
    own = self_ns(recs)
    ns = sum(own[i] for i, r in enumerate(recs) if r.name in spans)
    ns += sum(r.timers[t][1] for r in recs for t in timers if t in r.timers)
    return _per_picture(run, ns / 1e6)


def count_per_picture(run, counter: str):
    """Counter `counter` summed over the window's spans, per picture."""
    recs = records(run)
    if recs is None:
        return None
    return _per_picture(run, sum(r.counters.get(counter, 0) for r in recs))


def wait_ms_per_picture(run):
    """Wall less the thread's CPU time over the spans with no parent: the
    time the decoding thread was blocked, in ms per picture."""
    recs = records(run)
    if recs is None:
        return None
    ns = sum(r.end - r.start - r.cpu for r in recs if r.parent is None and r.cpu is not None)
    return _per_picture(run, ns / 1e6)


def decode_thread(run):
    """The profiler's id of the thread the harness's spans ran on."""
    tids = {tid for name, _, _, tid in run.trace.spans if name in ("slice", "stream")}
    return tids.pop() if len(tids) == 1 else None


def device_ms_per_picture(run, spans):
    """Device time (the union of their intervals) of every operation
    launched on the decoding thread while a program span named in `spans`
    was open, whatever its name, in ms per picture."""
    recs = records(run)
    tid = decode_thread(run) if recs is not None else None
    if tid is None:
        return None
    open_ = devtrace.union((r.start, r.end) for r in recs if r.name in spans)
    starts = [s for s, _ in open_]
    ops = []
    for op, at in zip(run.trace.device_ops, run.trace.launched):
        if at is None or at[1] != tid:
            continue
        i = bisect.bisect_right(starts, at[0]) - 1
        if i >= 0 and at[0] < open_[i][1]:
            ops.append((op[1], op[2]))
    return _per_picture(run, devtrace.busy_ns(ops) / 1e6)
