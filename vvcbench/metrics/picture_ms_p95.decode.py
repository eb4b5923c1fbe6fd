"""picture_ms_p95.decode (ms): the 95th percentile of the time of a picture
(from the stream's start or the last picture's completion to its own, the
last of a stream to the stream's end), over every picture of the window."""

import statistics


def read(run):
    if len(run.picture_s) < 2:
        return None
    return 1e3 * statistics.quantiles(run.picture_s, n=20, method="inclusive")[-1]
