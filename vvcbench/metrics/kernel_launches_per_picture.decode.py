"""kernel_launches_per_picture.decode (launches): the program's
`kernel_launches` counter (every launch of a hand-written kernel,
kernels.launch), per picture of the traced window (progtrace.py)."""

from vvcbench import progtrace


def read(run):
    return progtrace.count_per_picture(run, "kernel_launches")
