"""rmd_ms_per_picture.encode (ms): self time of the spans around FrameRMD's
construction (the source's upload, the class tables, the RMD kernels'
launches) and its fetches from the device (the reductions, the chosen
leaves' rows), per picture."""


def read(run):
    s = run.span_self_s.get("rmd")
    if s is None or run.pictures == 0:
        return None
    return 1e3 * s / run.pictures
