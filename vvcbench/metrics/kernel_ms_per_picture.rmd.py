"""kernel_ms_per_picture.rmd (ms): device time (the union of their
intervals) of every operation launched under the harness's "rmd" spans
(FrameRMD's construction and fetches: the RMD kernels, uploads, gathers and
copies, whatever their names) in the traced window, per picture."""

from vvcbench import devtrace


def read(run):
    if run.trace is None or run.pictures == 0:
        return None
    s = devtrace.under_s(run.trace, "rmd")
    return 1e3 * s / run.pictures if s > 0 else None
