"""picture_ms_p95.encode (ms): the 95th percentile of the time of one encode
call (a fresh encoder, one frame, its one-picture stream), over every
picture of the window."""

import statistics


def read(run):
    if len(run.picture_s) < 2:
        return None
    return 1e3 * statistics.quantiles(run.picture_s, n=20, method="inclusive")[-1]
