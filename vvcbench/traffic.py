"""The one generator of traffic: the order in which a closed loop sends a
configuration's inputs, drawn from the seed."""

from __future__ import annotations

import random
from collections.abc import Iterator


def input_order(seed: int, n: int) -> Iterator[int]:
    """Indices of the configuration's `n` inputs, endlessly, in cycles that
    each send every input once, in an order drawn anew for each cycle from
    `seed`.  Every seed sends the same inputs; only their order differs."""
    rng = random.Random(seed)
    while True:
        cycle = list(range(n))
        rng.shuffle(cycle)
        yield from cycle
