"""The luma deblocking kernels' precondition on their maps, for the tests.

csrc/deblock.cu filters the edges of a line in parallel and relies on
disjoint filter extents: the samples an active luma edge at x = 4 c may
write, x - max_p .. x + max_q - 1, meet no other active edge's on the same
line (a row of the maps).  VVC's max_p / max_q rules guarantee it; the
plain versions do not need it.  `extents_disjoint` checks it in linear
time, `extents_disjoint_pairs` by comparing every pair of edges of a line
(the first form, kept to hold the linear one to it).
`recorded_deblock_maps` records the maps of every picture the port's
decoder deblocks, so a test that decodes a stream checks them without a
second decode.
"""

from __future__ import annotations

import contextlib

import numpy as np

from vtm_tpu_torch.ops import deblock as DB

# indices of l_active, l_maxp and l_maxq in a picture's luma maps
# (ops/filter_chain.py DMAP_FIELDS)
ACTIVE, MAX_P, MAX_Q = 0, 3, 4
LUMA_FIELDS = ("l_active", "l_tc", "l_beta", "l_maxp", "l_maxq")


def extents_disjoint(maps) -> bool:
    """Whether, on every line, each active edge's extent ends at or before
    the next active edge's begins (max_p and max_q are not negative, so the
    neighbouring pairs decide for every pair)."""
    act, max_p, max_q = (np.asarray(maps[i]) for i in (ACTIVE, MAX_P, MAX_Q))
    r, c = np.nonzero(act)  # line by line, each in column order
    x = 4 * c.astype(np.int64)
    end = x + max_q[r, c]  # past the last sample
    start = x - max_p[r, c]
    same_line = r[1:] == r[:-1]
    return not (same_line & (end[:-1] > start[1:])).any()


def extents_disjoint_pairs(maps) -> bool:
    """extents_disjoint over every pair of edges of a line: a (lines, W/4,
    W/4) array, for small maps only."""
    act, max_p, max_q = (np.asarray(maps[i], dtype=np.int64) for i in (ACTIVE, MAX_P, MAX_Q))
    x = 4 * np.arange(act.shape[1])
    end = np.where(act > 0, x + max_q, -1 << 20)[:, :, None]
    start = np.where(act > 0, x - max_p, 1 << 20)[:, None, :]
    later = x[:, None] < x[None, :]
    return not (later & (end > start)).any()


def luma_maps(pic_maps) -> tuple:
    """A picture's (VER, HOR) luma maps, HOR transposed so that its lines
    are rows (as the kernels see them)."""
    ver, hor = pic_maps
    return ([getattr(ver, f) for f in LUMA_FIELDS],
            [np.ascontiguousarray(getattr(hor, f).T) for f in LUMA_FIELDS])


@contextlib.contextmanager
def recorded_deblock_maps():
    """Yields a list that receives the [VER, HOR] maps of every
    DB.build_pic_maps call (decoder/filters.py calls it through the module)
    while the block runs."""
    real = DB.build_pic_maps
    got = []

    def record(dcs, pic):
        maps = real(dcs, pic)
        got.append(maps)
        return maps

    DB.build_pic_maps = record
    try:
        yield got
    finally:
        DB.build_pic_maps = real


def assert_luma_extents_disjoint(recorded, name: str) -> None:
    for k, pic_maps in enumerate(recorded):
        for d, maps in zip(("VER", "HOR"), luma_maps(pic_maps)):
            assert extents_disjoint(maps), \
                f"{name}: deblocked picture {k}, {d}: luma filter extents overlap"
