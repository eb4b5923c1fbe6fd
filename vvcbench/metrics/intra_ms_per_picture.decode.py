"""intra_ms_per_picture.decode (ms): the program's `recon.intra` timer
(host intra reconstruction of each intra CU: prediction, inverse
transform, the residual), per picture of the traced window
(progtrace.py)."""

from vvcbench import progtrace


def read(run):
    return progtrace.ms_per_picture(run, timers=("recon.intra",))
