"""kernel_ms_per_picture.inter_batches (ms): device time (the union of
their intervals) of every operation launched while the program's
`inter.mc`, `inter.dmvr` or `inter.bdof` span was open: the inter kernels,
the torch operations and the copies between them, whatever their names;
per picture of the traced window (progtrace.py)."""

from vvcbench import progtrace


def read(run):
    return progtrace.device_ms_per_picture(run, ("inter.mc", "inter.dmvr", "inter.bdof"))
