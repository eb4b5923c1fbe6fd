"""maps_ms_per_picture.decode (ms): the self time of the program's
`maps.deblock`, `maps.sao` and `maps.alf` spans (the in-loop filters'
parameters built on the host), per picture of the traced window
(progtrace.py)."""

from vvcbench import progtrace


def read(run):
    return progtrace.ms_per_picture(run, spans=("maps.deblock", "maps.sao", "maps.alf"))
