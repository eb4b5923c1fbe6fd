"""slice_ms_per_picture.decode (ms): self time of the span around
Decoder._decode_slice (parsing, CABAC, reconstruction and the MC, DMVR and
BDOF batches it sends; the picture finish it calls is left out), per
picture."""


def read(run):
    s = run.span_self_s.get("slice")
    if s is None or run.pictures == 0:
        return None
    return 1e3 * s / run.pictures
