"""The yardstick's count of the encoder's RMD stage (rough mode decision:
every intra mode's prediction and SATD at every position of every block
size the partitioner can reach), a frozen copy of chip_smoke.py's
`rmd_ops` over the classes and positions of encoder/rmd.py:FrameRMD.

Operations of a class: positions x columns x samples x (4 for the 4-tap
prediction + the SATD's per sample: the butterflies of its Hadamard tile,
log2 of the tile's size, plus the absolute value and the sum; 2 for a block
that falls back to the SAD).  Columns: the 67 angular modes, and with MIP
two (the mode and its transpose) for each MIP mode of the block's size
class.  Bytes: the padded source plane read once as int32, and the five
int32 reductions of each position written once.  Counted as one operation
against the card's int32 peak (yardstick.least_s).
"""

from __future__ import annotations

N_ANG = 67
PAD_R = 2 * 64 + 2  # the source plane's right and bottom padding
MIP_MODES = (16, 8, 6)  # MIP modes of size ids 0, 1, 2
REDUCED_COLUMNS = 5  # best angular cost and mode, planar, best MIP cost and mode
# Hadamard tiles (h, w) in the order of ops/rdcost.py:KINDS; None: the SAD
TILES = ((8, 16), (16, 8), (4, 8), (8, 4), (8, 8), (4, 4), (2, 2), None)


def classes(enc: dict) -> list[tuple[int, int]]:
    """(w, h) of the size classes the intra partitioner reaches (QT squares,
    rectangles from at least one MTT split, no side over 32 or ratio over
    8), as encoder/rmd.py:intra_class_list lists them."""
    out = []
    for lw in range(2, enc["log2_ctu_size"] + 1):
        for lh in range(2, enc["log2_ctu_size"] + 1):
            w, h = 1 << lw, 1 << lh
            if w == h:
                out.append((w, h))
            elif (max(w, h) <= (1 << enc["log2_max_bt_intra"]) * 2
                  and enc["max_mtt_depth_intra"] > 0
                  and max(w, h) // min(w, h) <= 8 and max(w, h) <= 32):
                out.append((w, h))
    return out


def _stride(d: int) -> int:
    return 4 if d <= 8 else 8 if d <= 16 else d


def positions(w: int, h: int, pic_w: int, pic_h: int) -> int:
    """Positions of a w x h class in the picture: every 4 samples up to 8,
    every 8 up to 16, at the block's own alignment above."""
    if w > pic_w or h > pic_h:
        return 0
    return ((pic_w - w) // _stride(w) + 1) * ((pic_h - h) // _stride(h) + 1)


def tile(h: int, w: int):
    """The Hadamard tile an h x w block is cut into (ops/rdcost.py:satd_kind)."""
    if w > h and h % 8 == 0 and w % 16 == 0:
        return TILES[0]
    if w < h and w % 8 == 0 and h % 16 == 0:
        return TILES[1]
    if w > h and h % 4 == 0 and w % 8 == 0:
        return TILES[2]
    if w < h and w % 4 == 0 and h % 8 == 0:
        return TILES[3]
    if h % 8 == 0 and w % 8 == 0:
        return TILES[4]
    if h % 4 == 0 and w % 4 == 0:
        return TILES[5]
    if h % 2 == 0 and w % 2 == 0:
        return TILES[6]
    return None


def satd_ops(h: int, w: int) -> int:
    t = tile(h, w)
    return 2 if t is None else (t[0] * t[1]).bit_length() - 1 + 2


def mip_size_id(w: int, h: int) -> int:
    if w == 4 and h == 4:
        return 0
    if w == 4 or h == 4 or (w == 8 and h == 8):
        return 1
    return 2


def columns(w: int, h: int, mip: bool) -> int:
    with_mip = mip and w <= 64 and h <= 64
    return N_ANG + (2 * MIP_MODES[mip_size_id(w, h)] if with_mip else 0)


def frame_work(enc: dict) -> tuple[int, int]:
    """(bytes, int32 operations) of one picture's RMD stage under the
    encoder settings `enc` (EncoderConfig's keywords)."""
    pic_w, pic_h = enc["width"], enc["height"]
    ops, nbytes = 0, 4 * (pic_w + 1 + PAD_R) * (pic_h + 1 + PAD_R)
    for w, h in classes(enc):
        p = positions(w, h, pic_w, pic_h)
        ops += p * columns(w, h, enc["mip"]) * h * w * (4 + satd_ops(h, w))
        nbytes += 4 * REDUCED_COLUMNS * p
    return nbytes, ops
