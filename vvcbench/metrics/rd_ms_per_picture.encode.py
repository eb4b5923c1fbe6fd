"""rd_ms_per_picture.encode (ms): self time of the span around each encode
call, less the RMD, deblocking and SAO / ALF spans inside it: the host's RD
search (the fast-RD partition, mode and transform trials, quantisation) and
CABAC writing, per picture."""


def read(run):
    s = run.span_self_s.get("picture")
    if s is None or run.pictures == 0:
        return None
    return 1e3 * s / run.pictures
