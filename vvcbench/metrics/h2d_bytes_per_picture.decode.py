"""h2d_bytes_per_picture.decode (bytes): the program's `h2d_bytes` counter
(the bytes of every host-to-device copy of the decode), per picture of the
traced window (progtrace.py)."""

from vvcbench import progtrace


def read(run):
    return progtrace.count_per_picture(run, "h2d_bytes")
