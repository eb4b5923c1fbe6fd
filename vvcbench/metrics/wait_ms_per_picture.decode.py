"""wait_ms_per_picture.decode (ms): wall time less the decoding thread's
CPU time over the program's outermost spans: the time the thread was
blocked (device syncs, waits on other threads), per picture of the traced
window (progtrace.py)."""

from vvcbench import progtrace


def read(run):
    return progtrace.wait_ms_per_picture(run)
