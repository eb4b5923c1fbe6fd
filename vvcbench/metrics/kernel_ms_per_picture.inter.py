"""kernel_ms_per_picture.inter (ms): device time of the inter kernels (MC,
DMVR, the final FIR, BDOF) in the traced window, per picture."""

from vvcbench import devtrace, yardstick


def read(run):
    if run.trace is None or run.pictures == 0:
        return None
    s = devtrace.family_s(run.trace, yardstick.INTER_KERNELS)
    return 1e3 * s / run.pictures if s > 0 else None
