"""chain_roofline (%): the in-loop chain's least time, counted as one
operation over every chain call of the window (yardstick.chain_work), over
the device time of every operation launched inside the chain (the
"vvcbench.chain" range around ops/filter_chain.py:chain_body): its kernels,
the torch operations between them and any copy or set, whatever their
names."""

from vvcbench import devtrace, yardstick


def read(run):
    if run.trace is None or not run.chain_calls:
        return None
    device_s = devtrace.under_s(run.trace, "chain")
    if device_s <= 0:
        return None
    ctu = run.config["CTUSize"]
    work = [yardstick.chain_work(shapes, bd, fl, ctu) for shapes, bd, fl in run.chain_calls]
    least = yardstick.least_s(sum(b for b, _ in work), sum(o for _, o in work))
    return 100.0 * least / device_s
