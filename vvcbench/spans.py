"""Host-clock spans that the harness wraps around the program's calls.

A span's self time is its duration less that of the spans opened inside
it.  Each span is also a profiler range (`vvcbench.<name>`), so that the
device trace can tell what the host was doing during an idle gap.
"""

from __future__ import annotations

import time
from contextlib import contextmanager


class Spans:
    def __init__(self):
        self.self_s: dict[str, float] = {}
        self._stack: list[list[float]] = []  # [children's seconds] per open span

    def reset(self) -> None:
        self.self_s.clear()

    @contextmanager
    def span(self, name: str):
        from torch.profiler import record_function

        self._stack.append([0.0])
        t0 = time.perf_counter()
        try:
            with record_function(f"vvcbench.{name}"):
                yield
        finally:
            total = time.perf_counter() - t0
            children = self._stack.pop()[0]
            if self._stack:
                self._stack[-1][0] += total
            self.self_s[name] = self.self_s.get(name, 0.0) + total - children


def wrap(owner, attr: str, make):
    """Replace owner.attr by make(original); returns a function that puts the
    original back."""
    orig = getattr(owner, attr)
    setattr(owner, attr, make(orig))
    return lambda: setattr(owner, attr, orig)
