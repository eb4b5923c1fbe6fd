"""Motion-constrained tile sets: MV legality checks.

Behavioral counterpart of CommonLib/MCTS.h MCTSHelper (:74-86): an
encoder constraint mode that keeps every prediction block's reference
reads inside its own tile so tiles stay independently decodable (and,
for us, cleanly shardable across chips without reference halos).

The sub-pel restriction shrinks the tile by the interpolation-filter
support: 8-tap luma MC reads 3 samples left/above and 4 right/below of
the integer block, so a quarter-pel MV is legal only if the stretched
read area stays inside the tile.
"""

from __future__ import annotations

MV_FRAC_BITS = 4  # internal 1/16-pel
LUMA_TAPS_LEFT = 3
LUMA_TAPS_RIGHT = 4


def tile_area(dcs, x: int, y: int):
    """(tx, ty, tw, th) of the tile containing luma position (x, y)."""
    pps = dcs.pps
    col = pps.ctu_to_tile_col[x >> dcs.sps.ctu_size_log2] \
        if hasattr(pps, "ctu_to_tile_col") else 0
    row = pps.ctu_to_tile_row[y >> dcs.sps.ctu_size_log2] \
        if hasattr(pps, "ctu_to_tile_row") else 0
    ctu = dcs.sps.ctu_size
    if hasattr(pps, "tile_col_bd"):
        x0 = pps.tile_col_bd[col] * ctu
        x1 = (pps.tile_col_bd[col + 1] * ctu
              if col + 1 < len(pps.tile_col_bd) else dcs.pic_w)
        y0 = pps.tile_row_bd[row] * ctu
        y1 = (pps.tile_row_bd[row + 1] * ctu
              if row + 1 < len(pps.tile_row_bd) else dcs.pic_h)
    else:
        x0, y0, x1, y1 = 0, 0, dcs.pic_w, dcs.pic_h
    return x0, y0, min(x1, dcs.pic_w) - x0, min(y1, dcs.pic_h) - y0


def restricted_area(tile, frac: bool):
    """Tile shrunk by the MC filter support (sub-pel) or unchanged
    (integer MV)."""
    tx, ty, tw, th = tile
    if not frac:
        return tx, ty, tw, th
    return (tx + LUMA_TAPS_LEFT, ty + LUMA_TAPS_LEFT,
            tw - LUMA_TAPS_LEFT - LUMA_TAPS_RIGHT,
            th - LUMA_TAPS_LEFT - LUMA_TAPS_RIGHT)


def check_mv(dcs, block, mv) -> bool:
    """MCTSHelper::checkMvForMCTSConstraint: True iff the MC read area of
    `block` (x, y, w, h luma) displaced by `mv` (1/16-pel internal) stays
    inside its tile (sub-pel support included when mv is fractional)."""
    bx, by, bw, bh = block
    frac = (mv[0] & ((1 << MV_FRAC_BITS) - 1)) != 0 or \
        (mv[1] & ((1 << MV_FRAC_BITS) - 1)) != 0
    tx, ty, tw, th = restricted_area(tile_area(dcs, bx, by), frac)
    rx = bx + (mv[0] >> MV_FRAC_BITS)
    ry = by + (mv[1] >> MV_FRAC_BITS)
    return tx <= rx and rx + bw <= tx + tw and \
        ty <= ry and ry + bh <= ty + th


def clip_mv_to_area(mv, block, area):
    """MCTSHelper::clipMvToArea: clamp an internal-precision MV so the
    displaced block stays inside `area` (integer-pel clamp)."""
    bx, by, bw, bh = block
    ax, ay, aw, ah = area
    mx = min(max(mv[0], (ax - bx) << MV_FRAC_BITS),
             (ax + aw - bw - bx) << MV_FRAC_BITS)
    my = min(max(mv[1], (ay - by) << MV_FRAC_BITS),
             (ay + ah - bh - by) << MV_FRAC_BITS)
    return (mx, my)
