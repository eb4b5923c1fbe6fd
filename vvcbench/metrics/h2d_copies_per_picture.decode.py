"""h2d_copies_per_picture.decode (copies): the program's `h2d_copies`
counter (every host-to-device copy of the decode, ops.host_to_device), per
picture of the traced window (progtrace.py)."""

from vvcbench import progtrace


def read(run):
    return progtrace.count_per_picture(run, "h2d_copies")
