"""Decode-side coding structure.

Array-backed re-design of the reference's CodingStructure (CodingStructure.h:
71-180): instead of pointer-linked CU/PU/TU pools with sub-structure cloning,
the decoder keeps plain dataclasses plus per-channel spatial index maps at
minimum-block granularity (4x4 luma units, 2x2 chroma units) for neighbor
lookup (getCU/getPU/getCURestricted equivalents).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from vtm_tpu_torch.common.types import ChromaFormat

# pred modes
MODE_INTER, MODE_INTRA, MODE_IBC, MODE_PLT = 0, 1, 2, 3
# tree types
TREE_D, TREE_L, TREE_C = 0, 1, 2
# mode types
MODE_TYPE_ALL, MODE_TYPE_INTER, MODE_TYPE_INTRA = 0, 1, 2
# channel
CH_L, CH_C = 0, 1

PLANAR_IDX = 0
DC_IDX = 1
HOR_IDX = 18
VER_IDX = 50
VDIA_IDX = 66
NUM_LUMA_MODE = 67
LM_CHROMA_IDX = 67
MDLM_L_IDX = 68
MDLM_T_IDX = 69
DM_CHROMA_IDX = 70
NUM_CHROMA_MODE = 8
MTS_DCT2_DCT2, MTS_SKIP, MTS_DST7_DST7, MTS_DCT8_DST7, MTS_DST7_DCT8, MTS_DCT8_DCT8 = 0, 1, 2, 3, 4, 5


@dataclass
class Rect:
    x: int = 0
    y: int = 0
    w: int = 0
    h: int = 0

    @property
    def x1(self):
        return self.x + self.w

    @property
    def y1(self):
        return self.y + self.h

    def contains(self, px, py):
        return self.x <= px < self.x1 and self.y <= py < self.y1


@dataclass
class TU:
    # per-component rects in component coords; None if not valid
    blocks: list[Rect | None]
    cu: "CU"
    depth: int = 0
    cbf: list[int] = field(default_factory=lambda: [0, 0, 0])
    mts_idx: list[int] = field(default_factory=lambda: [0, 0, 0])
    coeffs: list[np.ndarray | None] = field(default_factory=lambda: [None, None, None])
    joint_cbcr: int = 0
    no_residual: bool = False
    chroma_qp: list[int] = field(default_factory=lambda: [0, 0, 0])


@dataclass
class CU:
    ch_type: int
    tree_type: int
    mode_type: int
    blocks: list[Rect | None]  # per-component areas (component coords)
    chroma_format: ChromaFormat
    pred_mode: int = MODE_INTRA
    skip: bool = False
    root_cbf: bool = True
    qp: int = 0
    chroma_qp_adj: int = 0
    qt_depth: int = 0
    depth: int = 0
    bdpcm_mode: int = 0
    bdpcm_mode_chroma: int = 0
    # defaults match PredictionUnit::initData (Unit.cpp:523-524): DM chroma
    # over a non-intra (IBC/PLT) luma CU reads the DC default
    intra_dir: list[int] = field(default_factory=lambda: [DC_IDX, PLANAR_IDX])
    mip_flag: bool = False
    mip_transposed: bool = False
    multi_ref_idx: int = 0
    isp_mode: int = 0
    lfnst_idx: int = 0
    color_transform: bool = False
    sbt_info: int = 0
    tile_idx: int = 0
    slice_idx: int = 0
    idx: int = -1  # position in decode order (cs.cus index)
    sep_tree: bool = False  # treeType != TREE_D || CS::isDualITree
    split_series: tuple = ()  # split type per depth on the path from the CTU
    tus: list[TU] = field(default_factory=list)
    # ---- inter prediction data (single PU per CU in VVC) ----
    merge_flag: bool = False
    regular_merge_flag: bool = False
    mmvd_flag: bool = False
    mmvd_skip: bool = False
    mmvd_idx: int = 0
    merge_idx: int = 0
    merge_type: int = 0  # 0=default, 1=SbTMVP, 2=IBC
    interdir: int = 0  # 1=L0, 2=L1, 3=bi
    ref_idx: list = field(default_factory=lambda: [-1, -1])
    mvd: list = field(default_factory=lambda: [(0, 0), (0, 0)])
    mvp_idx: list = field(default_factory=lambda: [0, 0])
    mv: list = field(default_factory=lambda: [(0, 0), (0, 0)])
    imv: int = 0  # AMVR mode: 0=1/4, 1=int, 2=4pel, 3=half
    affine: bool = False
    affine_type: int = 0
    mvd_affi: list = field(default_factory=lambda: [[(0, 0)] * 3, [(0, 0)] * 3])
    mv_affi: list = field(default_factory=lambda: [[(0, 0)] * 3, [(0, 0)] * 3])
    smvd_mode: int = 0
    ciip_flag: bool = False
    # ---- palette (PLT) data, lazily allocated at parse ----
    plt: object = None  # PltData
    geo_flag: bool = False
    geo_split_dir: int = 0
    geo_merge_idx: list = field(default_factory=lambda: [0, 0])
    bcw_idx: int = 2  # BCW_DEFAULT

    @property
    def lx(self):
        """luma-coords x (blocks may lack Y for dual-tree chroma)."""
        b = self.blocks[0]
        if b is not None:
            return b.x
        return self.blocks[1].x << self.chroma_format.scale_x

    @property
    def ly(self):
        b = self.blocks[0]
        if b is not None:
            return b.y
        return self.blocks[1].y << self.chroma_format.scale_y

    @property
    def lwidth(self):
        b = self.blocks[0]
        if b is not None:
            return b.w
        return self.blocks[1].w << self.chroma_format.scale_x

    @property
    def lheight(self):
        b = self.blocks[0]
        if b is not None:
            return b.h
        return self.blocks[1].h << self.chroma_format.scale_y

    @property
    def is_sep_tree(self) -> bool:
        return self.sep_tree or self.tree_type != TREE_D


MAXPLTSIZE, MAXPLTSIZE_DUALTREE = 31, 15
MAXPLTPREDSIZE, MAXPLTPREDSIZE_DUALTREE = 63, 31


class PltData:
    """Per-CU palette state (CodingUnit curPLT*/reuseflag/runtype fields)."""

    def __init__(self):
        self.last_size = [0, 0]        # lastPLTSize per channel (Y-begin / Cb-begin)
        self.cur_size = [0, 0]         # curPLTSize
        self.cur = np.zeros((3, MAXPLTSIZE), dtype=np.int32)   # curPLT
        self.reuse = np.zeros((2, MAXPLTPREDSIZE), dtype=bool)  # reuseflag
        self.use_escape = [False, False]
        self.use_rotation = [False, False]
        self.idx = [None, None]        # per-channel index map (h, w)
        self.run_type = [None, None]
        self.escape = [None, None, None]  # per-component escape values


class PltPredictor:
    """CodingStructure::prevPLT (PLTBuf)."""

    def __init__(self):
        self.size = [0, 0]
        self.plt = np.zeros((3, MAXPLTPREDSIZE), dtype=np.int32)

    def reset(self):
        self.size = [0, 0]
        self.plt.fill(0)

    def copy(self) -> "PltPredictor":
        p = PltPredictor()
        p.size = list(self.size)
        p.plt = self.plt.copy()
        return p

    def set_from(self, other: "PltPredictor"):
        self.size = list(other.size)
        self.plt = other.plt.copy()


class DecCodingStructure:
    """Per-picture CU container + spatial index."""

    def __init__(self, sps, pps, ph, sh, slice_idx_of_ctu: np.ndarray):
        self.sps = sps
        self.pps = pps
        self.ph = ph
        self.sh = sh
        self.chroma_format = sps.chroma_format
        w, h = pps.pic_width, pps.pic_height
        self.pic_w, self.pic_h = w, h
        self.cus: list[CU] = []
        # each CU's slice_idx and tile_idx by its index in `cus`, grown by
        # add_cu: availability over many map positions at once
        self.cu_slice = np.zeros(64, dtype=np.int32)
        self.cu_tile = np.zeros(64, dtype=np.int32)
        # luma index at 4x4, chroma at 2x2 (chroma coords)
        self.map_l = np.full(((h + 3) >> 2, (w + 3) >> 2), -1, dtype=np.int32)
        cw = w >> self.chroma_format.scale_x if self.chroma_format != ChromaFormat.YUV400 else 0
        ch = h >> self.chroma_format.scale_y if self.chroma_format != ChromaFormat.YUV400 else 0
        self.map_c = (
            np.full(((ch + 1) >> 1, (cw + 1) >> 1), -1, dtype=np.int32)
            if cw else None
        )
        self.tus: list[TU] = []
        self.map_tu_l = np.full(((h + 3) >> 2, (w + 3) >> 2), -1, dtype=np.int32)
        self.map_tu_c = (
            np.full(((ch + 1) >> 1, (cw + 1) >> 1), -1, dtype=np.int32) if cw else None
        )
        # per-CTU tile index and slice index (raster CTU addr)
        self.ctu_size = sps.ctu_size
        self.pic_w_ctu = pps.pic_width_in_ctu(sps.ctu_size)
        self.pic_h_ctu = pps.pic_height_in_ctu(sps.ctu_size)
        self.slice_idx_of_ctu = slice_idx_of_ctu  # filled by the slice loop
        self.cur_slice_idx = 0
        # reconstruction planes (int32), borrowed from Picture
        self.planes: list[np.ndarray] = []
        # QP maps at 4x4 luma granularity for deblocking later
        self.qp_map_l = np.zeros_like(self.map_l)
        self.qp_map_c: np.ndarray | None = (
            np.zeros_like(self.map_c) if self.map_c is not None else None
        )
        # palette predictor (CodingStructure::prevPLT)
        self.prev_plt = PltPredictor()

    def tile_idx_at(self, lx: int, ly: int) -> int:
        cx = min(lx >> self.sps.log2_ctu_size, self.pic_w_ctu - 1)
        cy = min(ly >> self.sps.log2_ctu_size, self.pic_h_ctu - 1)
        pps = self.pps
        return (
            pps.ctu_to_tile_row[cy] * pps.num_tile_cols + pps.ctu_to_tile_col[cx]
        )

    def slice_idx_at(self, lx: int, ly: int) -> int:
        cx = lx >> self.sps.log2_ctu_size
        cy = ly >> self.sps.log2_ctu_size
        return int(self.slice_idx_of_ctu[cy * self.pic_w_ctu + cx])

    def add_cu(self, cu: CU) -> CU:
        idx = len(self.cus)
        cu.idx = idx
        self.cus.append(cu)
        cu.tile_idx = self.tile_idx_at(cu.lx, cu.ly)
        cu.slice_idx = self.cur_slice_idx
        if idx == len(self.cu_slice):
            self.cu_slice = np.concatenate([self.cu_slice, self.cu_slice])
            self.cu_tile = np.concatenate([self.cu_tile, self.cu_tile])
        self.cu_slice[idx] = cu.slice_idx
        self.cu_tile[idx] = cu.tile_idx
        if cu.tree_type != TREE_C and cu.blocks[0] is not None:
            b = cu.blocks[0]
            self.map_l[b.y >> 2 : b.y1 >> 2, b.x >> 2 : b.x1 >> 2] = idx
        if cu.tree_type != TREE_L and len(cu.blocks) > 1 and cu.blocks[1] is not None:
            b = cu.blocks[1]
            self.map_c[b.y >> 1 : b.y1 >> 1, b.x >> 1 : b.x1 >> 1] = idx
        return cu

    def reorder_prev_plt(self, cu, comp_begin: int, num_comp: int, joint: bool):
        """CodingStructure::reorderPrevPLT (CodingStructure.cpp:897):
        current palette first, then non-reused predictor entries."""
        p = cu.plt
        prev = self.prev_plt
        max_pred = MAXPLTPREDSIZE if joint else MAXPLTPREDSIZE_DUALTREE
        chb = 0 if comp_begin == 0 else 1
        cur_size = p.cur_size[chb]
        stuffed = np.zeros((3, MAXPLTPREDSIZE), dtype=np.int32)
        for c in range(comp_begin, comp_begin + num_comp):
            stuffed[c, :cur_size] = p.cur[c, :cur_size]
        stuff_n = [0, 0, 0]
        for ch in range(comp_begin, min(comp_begin + num_comp, 2)):
            for i in range(prev.size[chb]):
                if cur_size + stuff_n[ch] >= max_pred:
                    break
                if not p.reuse[chb][i]:
                    if ch == 0:
                        stuffed[0, cur_size + stuff_n[0]] = prev.plt[0, i]
                    else:
                        stuffed[1, cur_size + stuff_n[1]] = prev.plt[1, i]
                        stuffed[2, cur_size + stuff_n[1]] = prev.plt[2, i]
                    stuff_n[ch] += 1
        prev.size[chb] = cur_size + stuff_n[comp_begin]
        for c in range(comp_begin, comp_begin + num_comp):
            prev.plt[c, : prev.size[chb]] = stuffed[c, : prev.size[chb]]

    def add_tu(self, tu: TU) -> TU:
        idx = len(self.tus)
        self.tus.append(tu)
        if tu.blocks[0] is not None:
            b = tu.blocks[0]
            self.map_tu_l[b.y >> 2 : b.y1 >> 2, b.x >> 2 : b.x1 >> 2] = idx
        if tu.blocks[1] is not None and self.map_tu_c is not None:
            b = tu.blocks[1]
            self.map_tu_c[b.y >> 1 : b.y1 >> 1, b.x >> 1 : b.x1 >> 1] = idx
        return tu

    def get_tu(self, x: int, y: int, ch_type: int) -> TU | None:
        if x < 0 or y < 0:
            return None
        if ch_type == CH_L:
            if y >= self.pic_h or x >= self.pic_w:
                return None
            idx = self.map_tu_l[y >> 2, x >> 2]
        else:
            if self.map_tu_c is None:
                return None
            cw = self.pic_w >> self.chroma_format.scale_x
            chh = self.pic_h >> self.chroma_format.scale_y
            if y >= chh or x >= cw:
                return None
            idx = self.map_tu_c[y >> 1, x >> 1]
        return self.tus[idx] if idx >= 0 else None

    def get_cu(self, x: int, y: int, ch_type: int) -> CU | None:
        """Position in channel coords of ch_type."""
        if x < 0 or y < 0:
            return None
        if ch_type == CH_L:
            if y >= self.pic_h or x >= self.pic_w:
                return None
            idx = self.map_l[y >> 2, x >> 2]
        else:
            if self.map_c is None:
                return None
            cw = self.pic_w >> self.chroma_format.scale_x
            chh = self.pic_h >> self.chroma_format.scale_y
            if y >= chh or x >= cw:
                return None
            idx = self.map_c[y >> 1, x >> 1]
        return self.cus[idx] if idx >= 0 else None

    def get_cu_restricted(
        self, x: int, y: int, cur_x: int, cur_y: int, ch_type: int
    ) -> CU | None:
        """Neighbor CU availability (CodingStructure::getCURestricted).

        Coordinates in channel coords of ch_type; cur pos is the current
        block's top-left.
        """
        cu = self.get_cu(x, y, ch_type)
        if cu is None:
            return None
        scale_x = self.chroma_format.scale_x if ch_type == CH_C else 0
        scale_y = self.chroma_format.scale_y if ch_type == CH_C else 0
        lx, ly = x << scale_x, y << scale_y
        cur_lx, cur_ly = cur_x << scale_x, cur_y << scale_y
        if cu.slice_idx != self.cur_slice_idx or cu.tile_idx != self.tile_idx_at(
            cur_lx, cur_ly
        ):
            return None
        if self.sps.entropy_coding_sync:
            if (lx >> self.sps.log2_ctu_size) >= (cur_lx >> self.sps.log2_ctu_size) + 1:
                return None
        return cu
