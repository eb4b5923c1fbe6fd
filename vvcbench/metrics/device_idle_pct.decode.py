"""device_idle_pct.decode (%): the share of the traced window in which no
kernel, copy or set ran on the device (the union of their intervals)."""

from vvcbench import devtrace


def read(run):
    if run.trace is None or not run.trace.device_ops:
        return None
    lo, hi = run.trace.window
    busy = devtrace.busy_ns((s, e) for _, s, e in run.trace.device_ops)
    return 100.0 * (1.0 - busy / (hi - lo))
