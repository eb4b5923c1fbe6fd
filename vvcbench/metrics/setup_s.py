"""setup_s (s): process start to the first timed picture (imports, the
kernels' load or build, the warm-up)."""


def read(run):
    return run.setup_s if run.setup_s > 0 else None
