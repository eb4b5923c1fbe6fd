"""finish_ms_per_picture.decode (ms): self time of the span around
Decoder.finish_picture (filter maps, the in-loop chain's uploads and
launches, the picture's hand-over), per picture."""


def read(run):
    s = run.span_self_s.get("finish")
    if s is None or run.pictures == 0:
        return None
    return 1e3 * s / run.pictures
