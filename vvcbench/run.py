"""Run one cell of BENCHMARK.json on the card and print its result line.

    python3 vvcbench/run.py --workload ra-classD-decode --seed 7 --seconds 10 --trace 0

Run from the root of a checkout.  See vvcbench/harness.py.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

if __name__ == "__main__":
    # run as a script, Python puts vvcbench/ first on the path, where its
    # modules would shadow top-level ones: the checkout's root goes there
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    sys.path.insert(0, ROOT)
    from vvcbench.harness import main

    sys.exit(main(sys.argv[1:]))
