"""kernel_ms_per_picture.chain (ms): device time of every operation
launched inside the in-loop chain (the "vvcbench.chain" range around
ops/filter_chain.py:chain_body: deblocking, SAO, ALF, CC-ALF and the torch
operations between them) in the traced window, per picture."""

from vvcbench import devtrace


def read(run):
    if run.trace is None or run.pictures == 0:
        return None
    s = devtrace.under_s(run.trace, "chain")
    return 1e3 * s / run.pictures if s > 0 else None
