"""QT/BT/TT partitioner for decoding.

Behavioral equivalent of CommonLib/UnitPartitioner.cpp QTBTPartitioner
(initCtu:249, splitCurrArea:271, canSplit:366/458, getImplicitSplit:516,
nextPart:622, exitCurrSplit) plus the TU tiling (getMaxTuTiling) and ISP
sub-partitioner (TUIntraSubPartitioner).  Areas are tracked as luma
rectangles; chroma rects derive by format shifts.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from vtm_tpu_torch.common.types import ChromaFormat, SliceType
from vtm_tpu_torch.decoder.cs import (
    CH_C,
    CH_L,
    MODE_TYPE_ALL,
    MODE_TYPE_INTER,
    MODE_TYPE_INTRA,
    Rect,
    TREE_C,
    TREE_D,
    TREE_L,
)

# split modes (subset of reference PartSplit)
CTU_LEVEL = 0
CU_DONT_SPLIT = 1
CU_QUAD_SPLIT = 2
CU_HORZ_SPLIT = 3
CU_VERT_SPLIT = 4
CU_TRIH_SPLIT = 5
CU_TRIV_SPLIT = 6
TU_MAX_TR_SPLIT = 7
TU_1D_HORZ_SPLIT = 8  # ISP
TU_1D_VERT_SPLIT = 9

MAX_TB_SIZEY = 64
MIN_DUALTREE_CHROMA_WIDTH = 4
MIN_DUALTREE_CHROMA_SIZE = 16


def _z_order_tiles(n_h: int, n_v: int):
    """Z-scan order of an (n_v x n_h) tile grid (ref g_rsScanToZ tables)."""
    coords = []

    def rec(x0, y0, w, h):
        if w == 1 and h == 1:
            coords.append((x0, y0))
            return
        hw, hh = max(1, w // 2), max(1, h // 2)
        rec(x0, y0, hw, hh)
        if w > 1:
            rec(x0 + hw, y0, w - hw, hh)
        if h > 1:
            rec(x0, y0 + hh, hw, h - hh)
        if w > 1 and h > 1:
            rec(x0 + hw, y0 + hh, w - hw, h - hh)

    rec(0, 0, n_h, n_v)
    return coords


@dataclass
class PartLevel:
    split: int
    parts: list[Rect]
    idx: int = 0
    checked_implicit: bool = False
    is_implicit: bool = False
    implicit_split: int = CU_DONT_SPLIT
    can_qt_split: bool = True
    qg_enable: bool = True
    qg_chroma_enable: bool = True
    mode_type: int = MODE_TYPE_ALL


class Partitioner:
    """State machine over luma-coordinate areas."""

    def __init__(self, cs):
        self.cs = cs
        self.sps = cs.sps
        self.ph = cs.ph
        self.sh = cs.sh
        self.chroma_format: ChromaFormat = cs.chroma_format
        self.ch_type = CH_L
        self.tree_type = TREE_D
        self.mode_type = MODE_TYPE_ALL
        self.cur_depth = 0
        self.cur_tr_depth = 0
        self.cur_bt_depth = 0
        self.cur_mt_depth = 0
        self.cur_qt_depth = 0
        self.cur_subdiv = 0
        self.cur_implicit_bt_depth = 0
        self.stack: list[PartLevel] = []
        self.cur_qg_pos = (0, 0)
        self.cur_qg_chroma_pos = (0, 0)

    # -- area helpers -------------------------------------------------------

    def cur_area(self) -> Rect:
        lvl = self.stack[-1]
        return lvl.parts[lvl.idx]

    def cur_luma(self) -> Rect:
        return self.cur_area()

    def cur_chroma(self) -> Rect:
        a = self.cur_area()
        sx, sy = self.chroma_format.scale_x, self.chroma_format.scale_y
        return Rect(a.x >> sx, a.y >> sy, a.w >> sx, a.h >> sy)

    def cur_block(self) -> Rect:
        """current area in the active channel's coords."""
        return self.cur_chroma() if self.ch_type == CH_C else self.cur_area()

    def cur_part_idx(self) -> int:
        return self.stack[-1].idx

    # -- init ---------------------------------------------------------------

    def init_ctu(self, ctu: Rect, ch_type: int):
        self.cur_depth = self.cur_tr_depth = self.cur_bt_depth = 0
        self.cur_mt_depth = self.cur_qt_depth = self.cur_subdiv = 0
        self.cur_implicit_bt_depth = 0
        self.ch_type = ch_type
        self.stack = [PartLevel(CTU_LEVEL, [ctu])]
        self.tree_type = TREE_D
        self.mode_type = MODE_TYPE_ALL
        self.cur_qg_pos = (ctu.x, ctu.y)
        self.cur_qg_chroma_pos = (ctu.x, ctu.y)

    # -- limits (PreCalcValues getters) -------------------------------------

    def _val_idx(self) -> int:
        sh = self.sh
        if sh.slice_type == SliceType.I:
            if not self.sps.dual_i_tree:
                return 0
            return 0 if self.ch_type == CH_L else 2
        return 1

    def max_bt_depth(self) -> int:
        return self.ph.max_mtt_depth[self._val_idx()]

    def max_bt_size(self) -> int:
        return self.ph.max_bt_size[self._val_idx()]

    def min_bt_size(self) -> int:
        return 1 << self.sps.log2_min_cb_size

    def max_tt_size(self) -> int:
        return self.ph.max_tt_size[self._val_idx()]

    def min_tt_size(self) -> int:
        return 1 << self.sps.log2_min_cb_size

    def min_qt_size(self) -> int:
        return self.ph.min_qt_size[self._val_idx()]

    # -- quantization groups ------------------------------------------------

    def cur_qg_enable(self) -> bool:
        return self.stack[-1].qg_enable

    def cur_qg_chroma_enable(self) -> bool:
        return self.stack[-1].qg_chroma_enable

    def _cu_qp_delta_subdiv(self) -> int:
        if self.sh.slice_type == SliceType.I:
            return self.ph.cu_qp_delta_subdiv_intra
        return self.ph.cu_qp_delta_subdiv_inter

    def _cu_chroma_qp_offset_subdiv(self) -> int:
        if self.sh.slice_type == SliceType.I:
            return self.ph.cu_chroma_qp_offset_subdiv_intra
        return self.ph.cu_chroma_qp_offset_subdiv_inter

    # -- implicit split / canSplit ------------------------------------------

    def _is_dual_i_tree(self) -> bool:
        return self.sh.slice_type == SliceType.I and self.sps.dual_i_tree

    def get_implicit_split(self) -> int:
        lvl = self.stack[-1]
        if lvl.checked_implicit:
            return lvl.implicit_split
        a = self.cur_area()
        pic_w, pic_h = self.cs.pic_w, self.cs.pic_h
        is_bl_in = a.x < pic_w and a.y1 <= pic_h  # bottomLeft (x, y+h-1)
        is_tr_in = a.x1 <= pic_w and a.y < pic_h  # topRight
        split = CU_DONT_SPLIT
        max_bt = self.max_bt_size()
        bt_allowed = (
            a.w <= max_bt
            and a.h <= max_bt
            and self.cur_mt_depth < self.max_bt_depth() + self.cur_implicit_bt_depth
        )
        min_qt = self.min_qt_size()
        qt_allowed = a.w > min_qt and a.h > min_qt and self.cur_bt_depth == 0
        if not is_bl_in and not is_tr_in and qt_allowed:
            split = CU_QUAD_SPLIT
        elif not is_bl_in and bt_allowed and a.w <= MAX_TB_SIZEY:
            split = CU_HORZ_SPLIT
        elif not is_tr_in and bt_allowed and a.h <= MAX_TB_SIZEY:
            split = CU_VERT_SPLIT
        elif not is_bl_in or not is_tr_in:
            split = CU_QUAD_SPLIT
        if self._is_dual_i_tree() and (a.w > 64 or a.h > 64):
            split = CU_QUAD_SPLIT
        if (not is_bl_in or not is_tr_in) and split == CU_DONT_SPLIT:
            split = CU_QUAD_SPLIT
        lvl.checked_implicit = True
        lvl.is_implicit = split != CU_DONT_SPLIT
        lvl.implicit_split = split
        return split

    def can_split_flags(self):
        """Returns (canNo, canQt, canBh, canBv, canTh, canTv)."""
        implicit = self.get_implicit_split()
        max_btd = self.max_bt_depth() + self.cur_implicit_bt_depth
        max_bt_size = self.max_bt_size()
        min_bt_size = self.min_bt_size()
        max_tt_size = self.max_tt_size()
        min_tt_size = self.min_tt_size()
        min_qt_size = self.min_qt_size()
        can_no = can_qt = can_bh = can_th = can_bv = can_tv = True
        can_btt = self.cur_mt_depth < max_btd
        a = self.cur_area()  # luma coords
        area_c = self.cur_chroma() if self.ch_type == CH_C else None
        lvl = self.stack[-1]
        last_split = lvl.split
        parl_split = CU_HORZ_SPLIT if last_split == CU_TRIH_SPLIT else CU_VERT_SPLIT
        if last_split != CTU_LEVEL and last_split != CU_QUAD_SPLIT:
            can_qt = False
        if a.w <= min_qt_size:
            can_qt = False
        if area_c is not None and area_c.w <= MIN_DUALTREE_CHROMA_WIDTH:
            can_qt = False
        if self.tree_type == TREE_C:
            return (True, False, False, False, False, False)
        if implicit != CU_DONT_SPLIT:
            can_no = can_th = can_tv = False
            can_bh = implicit == CU_HORZ_SPLIT
            can_bv = implicit == CU_VERT_SPLIT
            if area_c is not None and area_c.w == 4:
                can_bv = False
            if not can_bh and not can_bv and not can_qt:
                can_qt = True
            return (can_no, can_qt, can_bh, can_bv, False, False)
        if last_split in (CU_TRIH_SPLIT, CU_TRIV_SPLIT) and self.cur_part_idx() == 1:
            can_bh = parl_split != CU_HORZ_SPLIT
            can_bv = parl_split != CU_VERT_SPLIT
        if can_btt and (a.w <= min_bt_size and a.h <= min_bt_size) and (
            a.w <= min_tt_size and a.h <= min_tt_size
        ):
            can_btt = False
        if can_btt and (a.w > max_bt_size or a.h > max_bt_size) and (
            a.w > max_tt_size or a.h > max_tt_size
        ):
            can_btt = False
        if not can_btt:
            return (can_no, can_qt, False, False, False, False)
        if a.w > max_bt_size or a.h > max_bt_size:
            can_bh = can_bv = False
        if a.h <= min_bt_size:
            can_bh = False
        if a.w > MAX_TB_SIZEY and a.h <= MAX_TB_SIZEY:
            can_bh = False
        if area_c is not None and area_c.w * area_c.h <= MIN_DUALTREE_CHROMA_SIZE:
            can_bh = False
        if a.w <= min_bt_size:
            can_bv = False
        if a.w <= MAX_TB_SIZEY and a.h > MAX_TB_SIZEY:
            can_bv = False
        if area_c is not None and (
            area_c.w * area_c.h <= MIN_DUALTREE_CHROMA_SIZE or area_c.w == 4
        ):
            can_bv = False
        if self.mode_type == MODE_TYPE_INTER and a.w * a.h == 32:
            can_bv = can_bh = False
        if a.h <= 2 * min_tt_size or a.h > max_tt_size or a.w > max_tt_size:
            can_th = False
        if a.w > MAX_TB_SIZEY or a.h > MAX_TB_SIZEY:
            can_th = False
        if area_c is not None and area_c.w * area_c.h <= MIN_DUALTREE_CHROMA_SIZE * 2:
            can_th = False
        if a.w <= 2 * min_tt_size or a.w > max_tt_size or a.h > max_tt_size:
            can_tv = False
        if a.w > MAX_TB_SIZEY or a.h > MAX_TB_SIZEY:
            can_tv = False
        if area_c is not None and (
            area_c.w * area_c.h <= MIN_DUALTREE_CHROMA_SIZE * 2 or area_c.w == 8
        ):
            can_tv = False
        if self.mode_type == MODE_TYPE_INTER and a.w * a.h == 64:
            can_tv = can_th = False
        return (can_no, can_qt, can_bh, can_bv, can_th, can_tv)

    def can_split(self, split: int) -> bool:
        if split == CTU_LEVEL:
            return True
        if split == TU_MAX_TR_SPLIT:
            a = self.cur_area()
            max_tr = 1 << self.sps.log2_max_tb_size
            return a.w > max_tr or a.h > max_tr
        can_no, can_qt, can_bh, can_bv, can_th, can_tv = self.can_split_flags()
        return {
            CU_QUAD_SPLIT: can_qt,
            CU_DONT_SPLIT: can_no,
            CU_HORZ_SPLIT: can_bh,
            CU_VERT_SPLIT: can_bv,
            CU_TRIH_SPLIT: can_th,
            CU_TRIV_SPLIT: can_tv,
        }.get(split, False)

    # -- sub-partition geometry --------------------------------------------

    def _sub_parts(self, split: int) -> list[Rect]:
        a = self.cur_area()
        if split == CU_QUAD_SPLIT:
            hw, hh = a.w >> 1, a.h >> 1
            return [
                Rect(a.x, a.y, hw, hh),
                Rect(a.x + hw, a.y, hw, hh),
                Rect(a.x, a.y + hh, hw, hh),
                Rect(a.x + hw, a.y + hh, hw, hh),
            ]
        if split == CU_HORZ_SPLIT:
            hh = a.h >> 1
            return [Rect(a.x, a.y, a.w, hh), Rect(a.x, a.y + hh, a.w, hh)]
        if split == CU_VERT_SPLIT:
            hw = a.w >> 1
            return [Rect(a.x, a.y, hw, a.h), Rect(a.x + hw, a.y, hw, a.h)]
        if split == CU_TRIH_SPLIT:
            q = a.h >> 2
            return [
                Rect(a.x, a.y, a.w, q),
                Rect(a.x, a.y + q, a.w, q * 2),
                Rect(a.x, a.y + 3 * q, a.w, q),
            ]
        if split == CU_TRIV_SPLIT:
            q = a.w >> 2
            return [
                Rect(a.x, a.y, q, a.h),
                Rect(a.x + q, a.y, q * 2, a.h),
                Rect(a.x + 3 * q, a.y, q, a.h),
            ]
        if split == TU_MAX_TR_SPLIT:
            max_tr = 64 if (a.w > 64 or a.h > 64) else (1 << self.sps.log2_max_tb_size)
            n_h = max(1, a.w // max_tr)
            n_v = max(1, a.h // max_tr)
            tw, th = a.w // n_h, a.h // n_v
            return [
                Rect(a.x + tw * x, a.y + th * y, tw, th)
                for (x, y) in _z_order_tiles(n_h, n_v)
            ]
        raise ValueError(f"unsupported split {split}")

    # -- stack ops ----------------------------------------------------------

    def split_cur_area(self, split: int):
        is_implicit = split == self.get_implicit_split()
        can_qt = self.can_split(CU_QUAD_SPLIT)
        qg = self.cur_qg_enable()
        qg_c = self.cur_qg_chroma_enable()
        lvl = PartLevel(split, self._sub_parts(split))
        lvl.mode_type = self.mode_type
        self.stack.append(lvl)
        self.cur_depth += 1
        self.cur_subdiv += 1
        if split == TU_MAX_TR_SPLIT:
            self.cur_tr_depth += 1
        elif split in (TU_1D_HORZ_SPLIT, TU_1D_VERT_SPLIT):
            self.cur_tr_depth += 1
        else:
            self.cur_tr_depth = 0
        if split in (CU_HORZ_SPLIT, CU_VERT_SPLIT, CU_TRIH_SPLIT, CU_TRIV_SPLIT):
            self.cur_bt_depth += 1
            if is_implicit:
                self.cur_implicit_bt_depth += 1
            self.cur_mt_depth += 1
            if split in (CU_TRIH_SPLIT, CU_TRIV_SPLIT):
                self.cur_bt_depth += 1
                self.cur_subdiv += 1
            lvl.can_qt_split = can_qt
        elif split == CU_QUAD_SPLIT:
            self.cur_mt_depth = 0
            self.cur_bt_depth = 0
            self.cur_qt_depth += 1
            self.cur_subdiv += 1
        qg = qg and self.cur_subdiv <= self._cu_qp_delta_subdiv()
        qg_c = qg_c and self.cur_subdiv <= self._cu_chroma_qp_offset_subdiv()
        lvl.qg_enable = qg
        lvl.qg_chroma_enable = qg_c
        if qg:
            a = self.cur_area()
            self.cur_qg_pos = (a.x, a.y)
        if qg_c:
            a = self.cur_area()
            self.cur_qg_chroma_pos = (a.x, a.y)

    def next_part(self) -> bool:
        lvl = self.stack[-1]
        lvl.idx += 1
        lvl.checked_implicit = False
        lvl.is_implicit = False
        if lvl.idx < len(lvl.parts):
            if lvl.split in (CU_TRIH_SPLIT, CU_TRIV_SPLIT):
                if lvl.idx == 1:
                    self.cur_bt_depth -= 1
                    self.cur_subdiv -= 1
                else:
                    self.cur_bt_depth += 1
                    self.cur_subdiv += 1
            if self.cur_qg_enable():
                a = self.cur_area()
                self.cur_qg_pos = (a.x, a.y)
            if self.cur_qg_chroma_enable():
                a = self.cur_area()
                self.cur_qg_chroma_pos = (a.x, a.y)
            return True
        return False

    def exit_cur_split(self):
        lvl = self.stack.pop()
        self.cur_depth -= 1
        self.cur_subdiv -= 1
        if self.cur_qg_enable():
            a = self.cur_area()
            self.cur_qg_pos = (a.x, a.y)
        if self.cur_qg_chroma_enable():
            a = self.cur_area()
            self.cur_qg_chroma_pos = (a.x, a.y)
        if lvl.split in (CU_HORZ_SPLIT, CU_VERT_SPLIT, CU_TRIH_SPLIT, CU_TRIV_SPLIT):
            self.cur_mt_depth -= 1
            if self.stack[-1].is_implicit:
                self.cur_implicit_bt_depth -= 1
            self.cur_bt_depth -= 1
            if lvl.split in (CU_TRIH_SPLIT, CU_TRIV_SPLIT) and lvl.idx != 1:
                self.cur_bt_depth -= 1
                self.cur_subdiv -= 1
        elif lvl.split in (TU_MAX_TR_SPLIT, TU_1D_HORZ_SPLIT, TU_1D_VERT_SPLIT):
            self.cur_tr_depth -= 1
        else:
            self.cur_qt_depth -= 1
            self.cur_subdiv -= 1
