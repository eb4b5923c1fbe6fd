"""The device trace of a `--trace 1` run, reduced.

torch.profiler records the window with CPU and CUDA activity.  The device's
busy time is the union of its kernel, copy and set intervals inside the
window (overlapping work counts once); idle gaps are labelled with the
innermost harness span (spans.py) open at their middle.  Each device
operation keeps the host's clock and thread at its launch, found through
its correlation id (the CUDA API call that launched it, else the host
operation it is linked to), so that the operations launched under a
harness range can be told apart whatever their names.
"""

from __future__ import annotations

import bisect
import re
from contextlib import contextmanager
from dataclasses import dataclass, field

WINDOW = "vvcbench.window"
TOP = 10
LONG = 80  # characters of a device operation's name in the breakdown


# the host's CUDA API calls (cudaLaunchKernel, cuLaunchKernel,
# cudaMemcpyAsync, ...), whose correlation ids are their device work's
HOST_LAUNCH = re.compile(r"cu(da)?[A-Z]")


@dataclass
class Trace:
    window: tuple[int, int]  # ns
    device_ops: list[tuple[str, int, int]]  # (name, start ns, end ns), clipped to the window
    # harness spans and ranges: (name without the prefix, start ns, end ns, host thread)
    spans: list[tuple]
    # for each device op, (host ns, host thread) at its launch, or None
    launched: list = field(default_factory=list)


@contextmanager
def profiled(device: str):
    """torch.profiler recording over the block, yielding the profiler."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device != "cpu":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()


def _is_operation(ev) -> bool:
    """Whether a device event is an operation, not the device's copy of a
    profiler range."""
    if ev.is_user_annotation():
        return False
    kind = ev.activity_type() if hasattr(ev, "activity_type") else ""
    return "annotation" not in kind and not ev.name().startswith("vvcbench.")


def reduce(prof) -> Trace:
    """The window, the device's operations and the harness's spans of a
    finished recording."""
    from torch.autograd import DeviceType

    return reduce_events(prof.profiler.kineto_results.events(), DeviceType.CUDA)


def reduce_events(events, cuda) -> Trace:
    """reduce() on the recording's events; `cuda` is their device type."""
    window, ops, spans = None, [], []
    launches, host_ops = {}, {}  # correlation id -> (host ns, thread)
    for ev in events:
        name = ev.name()
        if ev.device_type() == cuda:
            if _is_operation(ev):
                ops.append((name, ev.start_ns(), ev.end_ns(), ev.correlation_id(),
                            ev.linked_correlation_id()))
            continue
        at = (ev.start_ns(), ev.start_thread_id())
        if HOST_LAUNCH.match(name):
            launches[ev.correlation_id()] = at
        else:
            host_ops[ev.correlation_id()] = at
        if ev.is_user_annotation() and name.startswith("vvcbench."):
            if name == WINDOW:
                window = (ev.start_ns(), ev.end_ns())
            else:
                spans.append((name[len("vvcbench."):], ev.start_ns(), ev.end_ns(), at[1]))
    if window is None:
        raise RuntimeError("the trace holds no window range")
    lo, hi = window
    kept, launched = [], []
    for n, s, e, corr, linked in ops:
        if e > lo and s < hi:
            kept.append((n, max(s, lo), min(e, hi)))
            launched.append((corr and launches.get(corr)) or (linked and host_ops.get(linked))
                            or None)
    return Trace(window, kept, spans, launched)


def under(tr: Trace, span: str) -> list[tuple[str, int, int]]:
    """The device operations launched while a harness span or range named
    `span` was open on the launching thread (such ranges never nest)."""
    by_thread: dict = {}
    for name, s, e, tid in tr.spans:
        if name == span:
            by_thread.setdefault(tid, []).append((s, e))
    for r in by_thread.values():
        r.sort()
    out = []
    for op, at in zip(tr.device_ops, tr.launched):
        if at is None:
            continue
        t, tid = at
        r = by_thread.get(tid, ())
        i = bisect.bisect_right(r, (t, float("inf"))) - 1
        if i >= 0 and r[i][0] <= t < r[i][1]:
            out.append(op)
    return out


def under_s(tr: Trace, span: str) -> float:
    """Device seconds (the union of their intervals) of the operations
    launched under `span`."""
    return busy_ns((s, e) for _, s, e in under(tr, span)) / 1e9


def union(intervals) -> list[tuple[int, int]]:
    """Disjoint, sorted cover of (start, end) intervals."""
    out: list[list[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_ns(intervals) -> int:
    return sum(e - s for s, e in union(intervals))


def gaps(busy, lo: int, hi: int) -> list[tuple[int, int]]:
    """The idle intervals of [lo, hi] between disjoint sorted `busy` ones."""
    out, t = [], lo
    for s, e in busy:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def label(spans, t: int) -> str:
    """The innermost span open at t (the latest to open), else "harness"."""
    best = None
    for name, s, e, *_ in spans:
        if s <= t < e and (best is None or s > best[1]):
            best = (name, s)
    return best[0] if best else "harness"


def kernel_base(name: str) -> str:
    """A device function's name without "void ", template arguments and
    parameters: "void sao_kernel<false>(int const*, ...)" -> "sao_kernel"."""
    if name.startswith("void "):
        name = name[5:]
    return re.split(r"[<(]", name, maxsplit=1)[0].strip()


def kernel_short(name: str) -> str:
    """The name without "void " and a function's parameter list (a copy's
    "Memcpy HtoD (Pageable -> Device)" stays whole); a name longer than
    LONG without its template arguments too."""
    if name.startswith("void "):
        name = name[5:]
    depth = 0
    for i, ch in enumerate(name):
        depth += ch == "<"
        depth -= ch == ">"
        if ch == "(" and depth == 0 and i and (name[i - 1].isalnum() or name[i - 1] in "_>"):
            name = name[:i]
            break
    name = name.strip()
    if len(name) > LONG:
        name = name.split("<", 1)[0] + "<...>"
    return name


def family_s(tr: Trace, bases) -> float:
    """Device seconds of the operations whose kernel_base is in `bases`."""
    return sum(e - s for n, s, e in tr.device_ops if kernel_base(n) in bases) / 1e9


def breakdown(tr: Trace) -> dict:
    """The device operations that took most time, and the longest idle gaps
    by the span the host was in."""
    by: dict[str, int] = {}
    for n, s, e in tr.device_ops:
        k = kernel_short(n)
        by[k] = by.get(k, 0) + e - s
    ops = sorted(by.items(), key=lambda kv: -kv[1])[:TOP]
    idle = gaps(union((s, e) for _, s, e in tr.device_ops), *tr.window)
    idle.sort(key=lambda g: g[0] - g[1])
    return {"device_ops": [[k, v / 1e9] for k, v in ops],
            "idle_gaps": [[label(tr.spans, (s + e) // 2), (e - s) / 1e9]
                          for s, e in idle[:TOP]]}
