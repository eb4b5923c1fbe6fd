"""inter_ms_per_picture.decode (ms): the self time of the program's inter
spans (`inter.plan`: planning the slice's MC; `inter.mc`: the MC batch's
packing, upload, launch and fetch; `inter.dmvr`, `inter.bdof`: the DMVR and
BDOF batches) plus its `recon.inter` timer (each inter CU's
reconstruction), per picture of the traced window (progtrace.py)."""

from vvcbench import progtrace

SPANS = ("inter.plan", "inter.mc", "inter.dmvr", "inter.bdof")


def read(run):
    return progtrace.ms_per_picture(run, spans=SPANS, timers=("recon.inter",))
