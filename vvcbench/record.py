"""What one run leaves for the metric readers (metrics/*.py)."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Run:
    workload: str
    config: dict  # the configuration's file
    traffic: dict  # the traffic mix's file
    seed: int
    seconds: float
    traced: bool
    device: str  # "cuda"; "cpu" in the harness's own tests only
    setup_s: float = 0.0  # process start to the window's start
    window_s: float = 0.0  # the measured window, on the host's clock
    pictures: int = 0  # pictures completed in the window
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    # the numbers compared with the reference: name -> {"value", "limit"}
    checks: dict = field(default_factory=dict)
    # --trace 1 only
    picture_s: list = field(default_factory=list)  # each picture's time
    span_self_s: dict = field(default_factory=dict)  # harness span -> self seconds
    chain_calls: list = field(default_factory=list)  # (shapes, bit depth, stage flags)
    trace: object = None  # devtrace.Trace of the window

    @property
    def correct(self) -> bool:
        return self.attempted > 0 and all(
            c["value"] <= c["limit"] for c in self.checks.values())
