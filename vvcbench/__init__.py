"""The benchmark of vtm_tpu_torch, the PyTorch and CUDA port of the codec.

`python3 vvcbench/run.py --workload NAME --seed N --seconds S --trace 0|1`
runs one cell of `BENCHMARK.json` on the card and prints one JSON line.
Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by the name that `BENCHMARK.json` gives it:

- `configs/<config>.json`: the deployment, with its streams and, beside
  each stream, the reference decoder's log (`streams/*.dec.log`: VTM 9.3
  DecoderApp's MD5 of every output plane);
- `traffic/<traffic>.json`: the parameters of a mix, read by the runner it
  names (`runners/<runner>.py`);
- `metrics/<metric>.py`: a reader with `read(run)`, which returns the
  metric from the run's spans, counters and device trace, or None where it
  finds nothing to read.

The yardstick (peaks, the chain's operations and bytes, the reference
check, the trace reduction) lives here too, and imports nothing of the
program.  Nothing here imports jax or the jax package.
"""
