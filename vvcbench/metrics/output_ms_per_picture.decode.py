"""output_ms_per_picture.decode (ms): the self time of the program's
`fetch` (the blocking device-to-host copy of a picture's packed planes)
and `hash` (its decoded-picture-hash check) spans, per picture of the
traced window (progtrace.py)."""

from vvcbench import progtrace


def read(run):
    return progtrace.ms_per_picture(run, spans=("fetch", "hash"))
