"""upload_ms_per_picture.chain (ms): the self time of the program's
`chain.upload` span (the reconstruction and the filter maps moved to the
device for the in-loop chain), per picture of the traced window
(progtrace.py)."""

from vvcbench import progtrace


def read(run):
    return progtrace.ms_per_picture(run, spans=("chain.upload",))
