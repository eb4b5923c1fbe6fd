"""rmd_roofline (%): the RMD stage's least time, counted as one operation
(rmd_work.frame_work: every mode's prediction and SATD at every position of
every class, against the card's int32 peak), for each picture of the
window, over the device time of every operation launched under the "rmd"
spans."""

from vvcbench import devtrace, rmd_work, yardstick


def read(run):
    if run.trace is None or run.pictures == 0:
        return None
    device_s = devtrace.under_s(run.trace, "rmd")
    if device_s <= 0:
        return None
    nbytes, ops = rmd_work.frame_work(run.config["encoder"])
    return 100.0 * run.pictures * yardstick.least_s(nbytes, ops) / device_s
