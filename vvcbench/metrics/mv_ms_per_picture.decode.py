"""mv_ms_per_picture.decode (ms): the program's `mv` timer (MV derivation
and the HMVP updates, each CTU's CuReconstructor.derive_cus), per picture
of the traced window (progtrace.py)."""

from vvcbench import progtrace


def read(run):
    return progtrace.ms_per_picture(run, timers=("mv",))
