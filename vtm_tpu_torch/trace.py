"""Spans, timers and counters of the decode, on the profiler's clock.

Tracing is on exactly while a `torch.profiler` session is recording
(`torch.autograd.profiler._is_profiler_enabled`); there is no other switch.
To see where a decode spends its time, run it under the profiler:

    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        Decoder(device="cuda").decode_stream(bits)
    per_picture = trace.summary()

The program's ranges (`vtm.slice`, `vtm.finish`, `vtm.fetch`, ...) then sit
in the profiler's timeline beside the kernels and copies they launched, and
`summary()` gives each picture's self times, timers and counters.

- A span (`with span(name):`) records its name, its start and end on the
  clock the profiler stamps host events with (`time.time_ns()`), its
  parent, and the picture it belongs to: `new_picture`'s id (a process-wide
  count and the POC), given explicitly (`span(name, pic=...)`) or taken
  from the parent, else the picture begun last.  It also opens
  `torch.profiler.record_function("vtm.<name>")`.  A span with no parent
  also records the thread's CPU time, so that wall less CPU is the time the
  thread was blocked.
- A timer (`with timer(name):`) is for work that repeats per CTU or CU: a
  count and the nanoseconds, added to the innermost open span.
- A counter (`count(name, n)`) adds to the innermost open span.

While tracing is off every call costs one global read: `span` and `timer`
return one shared no-op object, `count` returns, nothing is stored and no
profiler range is entered.

Records stay in memory, at most `CAP` (the rest counted in `dropped()`),
and are cleared at the first span of a new profiler session, which shows
itself as a picture begun with tracing off.  `records(lo, hi)` selects the
spans of a time window.
"""

from __future__ import annotations

import gc
import itertools
import threading
import time

import torch.autograd.profiler as _P
from torch.profiler import record_function

CAP = 1 << 20  # records kept

_clock = time.time_ns
_cpu = time.thread_time_ns


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP = _Noop()

_records: list = []
_dropped = 0
_stale = False  # a picture began with tracing off since the last record
_current = None  # id of the picture begun last
_pictures = itertools.count()
_local = threading.local()


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


class Span:
    """One span's record; `timers` maps a name to [count, ns], `counters` a
    name to its sum.  `parent` is the enclosing Span, `cpu` the thread's CPU
    nanoseconds inside a span with no parent (else None)."""

    __slots__ = ("name", "pic", "parent", "start", "end", "cpu", "timers",
                 "counters", "_rf")

    def __init__(self, name: str, pic):
        self.name = name
        self.pic = pic
        self.parent = None
        self.start = self.end = 0
        self.cpu = None
        self.timers: dict = {}
        self.counters: dict = {}

    def __enter__(self):
        global _dropped
        st = _stack()
        if _stale and not st:
            clear()
        if st:
            self.parent = st[-1]
            if self.pic is None:
                self.pic = self.parent.pic
        if len(_records) < CAP:
            _records.append(self)
        else:
            _dropped += 1
        st.append(self)
        # the clock is read right after the profiler stamps the range it
        # enters, the collector held off so that no collection comes between
        self._rf = record_function("vtm." + self.name)
        collect = gc.isenabled()
        gc.disable()
        self._rf.__enter__()
        self.start = _clock()
        if collect:
            gc.enable()
        if self.parent is None:
            self.cpu = _cpu()
        return self

    def __exit__(self, *exc):
        if self.cpu is not None:
            self.cpu = _cpu() - self.cpu
        self.end = _clock()
        self._rf.__exit__(*exc)
        self._rf = None
        if self.pic is None:
            self.pic = _current
        _stack().pop()
        return False


class _Timer:
    __slots__ = ("name", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = _clock()
        return self

    def __exit__(self, *exc):
        dt = _clock() - self.t0
        st = _stack()
        if st:
            t = st[-1].timers.get(self.name)
            if t is None:
                st[-1].timers[self.name] = [1, dt]
            else:
                t[0] += 1
                t[1] += dt
        return False


def span(name: str, pic=None):
    """A span named `name` (of picture `pic`, else its parent's), or the
    shared no-op while tracing is off."""
    if not _P._is_profiler_enabled:
        return NOOP
    return Span(name, pic)


def timer(name: str):
    """A timer named `name` on the innermost open span, or the shared no-op
    while tracing is off."""
    if not _P._is_profiler_enabled:
        return NOOP
    return _Timer(name)


def count(name: str, n: int = 1) -> None:
    """Add `n` to counter `name` of the innermost open span (tracing on)."""
    if not _P._is_profiler_enabled:
        return
    st = _stack()
    if st:
        c = st[-1].counters
        c[name] = c.get(name, 0) + n


def new_picture(poc: int):
    """The id of a picture the decoder begins, (process-wide count, POC);
    None while tracing is off."""
    global _current, _stale
    if not _P._is_profiler_enabled:
        _stale = True
        return None
    _current = (next(_pictures), poc)
    return _current


def clear() -> None:
    global _dropped, _stale
    _records.clear()
    _dropped = 0
    _stale = False


def dropped() -> int:
    """Records not kept since the last clear (over CAP)."""
    return _dropped


def records(lo: int | None = None, hi: int | None = None) -> list:
    """The closed spans that lie inside [lo, hi] (ns, the profiler's clock),
    in the order they opened; with no bounds, all of them."""
    return [r for r in _records if r.end and (lo is None or r.start >= lo)
            and (hi is None or r.end <= hi)]


def self_ns(recs) -> dict:
    """Each record's own nanoseconds, in the order of `recs`: its duration
    less its timers and the durations of its children in `recs`."""
    pos = {id(r): i for i, r in enumerate(recs)}
    out = [r.end - r.start - sum(t[1] for t in r.timers.values()) for r in recs]
    for r in recs:
        i = pos.get(id(r.parent))
        if i is not None:
            out[i] -= r.end - r.start
    return out


def summary(lo: int | None = None, hi: int | None = None) -> dict:
    """Per picture id, of the spans inside [lo, hi]: {"self_ms": {span:
    ms}, "timers": {timer: [count, ms]}, "counters": {counter: n},
    "wall_ms", "cpu_ms" (over the spans with no parent)}.  Spans that
    belong to no picture are under None."""
    recs = records(lo, hi)
    own = self_ns(recs)
    out: dict = {}
    for i, r in enumerate(recs):
        p = out.setdefault(r.pic, {"self_ms": {}, "timers": {}, "counters": {},
                                   "wall_ms": 0.0, "cpu_ms": 0.0})
        p["self_ms"][r.name] = p["self_ms"].get(r.name, 0.0) + own[i] / 1e6
        for k, (n, ns) in r.timers.items():
            t = p["timers"].setdefault(k, [0, 0.0])
            t[0] += n
            t[1] += ns / 1e6
        for k, n in r.counters.items():
            p["counters"][k] = p["counters"].get(k, 0) + n
        if r.cpu is not None:
            p["wall_ms"] += (r.end - r.start) / 1e6
            p["cpu_ms"] += r.cpu / 1e6
    return out
