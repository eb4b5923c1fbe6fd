"""d2h_copies_per_picture.decode (copies): the program's `d2h_copies`
counter (every device-to-host copy of the decode, ops.to_host; each one a
sync), per picture of the traced window (progtrace.py)."""

from vvcbench import progtrace


def read(run):
    return progtrace.count_per_picture(run, "d2h_copies")
