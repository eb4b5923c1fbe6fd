"""Motion-vector derivation: merge lists, AMVP, HMVP, TMVP, motion field.

Behavioral equivalent of the reference's UnitTools PU:: motion helpers
(UnitTools.cpp: getInterMergeCandidates:917, addMergeHMVPCand:762,
fillMvpCand:1770, addMVPCandUnscaled:2210, addAMVPHMVPCand:2266,
getColocatedMVP:1458, spanMotionInfo:3104, saveMotionInHMVP:306) and
Mv precision helpers (Mv.h:120-270).

Instead of a pointer-linked PU web, the motion field is a set of numpy
arrays at 4x4 luma granularity on DecCodingStructure; MotionInfo is a
plain dataclass.  MVs are (hor, ver) ints at internal 1/16-pel precision.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from vtm_tpu_torch.decoder import cs as D

NOT_VALID = -1
MAX_NUM_HMVP_CANDS = 6
MAX_NUM_HMVP_AVMPCANDS = 4
AMVP_MAX_NUM_CANDS = 2
MV_FRACTIONAL_BITS_INTERNAL = 4
MV_BITS = 18
MV_MAX = (1 << (MV_BITS - 1)) - 1
MV_MIN = -(1 << (MV_BITS - 1))
IMV_OFF, IMV_FPEL, IMV_4PEL, IMV_HPEL = 0, 1, 2, 3
BCW_DEFAULT = 2  # g_BcwWeights index of weight 1/2 (CommonDef.h BCW_DEFAULT)
# amvr idx -> MV precision shift (from 4-pel units); internal = 6
_AMVR_PREC = [4, 2, 0, 3]  # quarter, int, 4pel, half  (Mv.cpp:43)
_PREC_INTERNAL = 6


# ---------------------------------------------------------------------------
# Mv precision helpers (plain ints)

def _change_prec_comp(v: int, shift: int) -> int:
    """Mv::changePrecision for one component; shift = dst - src."""
    if shift >= 0:
        return v << shift
    rs = -shift
    off = 1 << (rs - 1)
    return (v + off - 1) >> rs if v >= 0 else (v + off) >> rs

def change_precision(mv, src: int, dst: int):
    s = dst - src
    return (_change_prec_comp(mv[0], s), _change_prec_comp(mv[1], s))

def round_to_precision(mv, src: int, dst: int):
    return change_precision(change_precision(mv, src, dst), dst, src)

def round_trans_prec_internal_2_amvr(mv, imv: int):
    return round_to_precision(mv, _PREC_INTERNAL, _AMVR_PREC[imv])

def change_trans_prec_amvr_2_internal(mv, imv: int):
    return change_precision(mv, _AMVR_PREC[imv], _PREC_INTERNAL)

# amvr idx -> IBC BV precision shift (Mv.cpp:45: int, int, 4pel)
_AMVR_PREC_IBC = [2, 2, 0]

def change_ibc_prec_amvr_2_internal(mv, imv: int):
    return change_precision(mv, _AMVR_PREC_IBC[imv], _PREC_INTERNAL)

def round_ibc_prec_internal_2_amvr(mv, imv: int):
    return round_to_precision(mv, _PREC_INTERNAL, _AMVR_PREC_IBC[imv])

def clip_storage(mv):
    c = lambda v: max(-(1 << 17), min((1 << 17) - 1, v))
    return (c(mv[0]), c(mv[1]))

def mv_clip_periodic(mv):
    """Mv::mvCliptoStorageBitDepth (periodic wrap, Mv.h:264)."""
    period = 1 << 18
    half = period >> 1
    def w(v):
        v = (v + period) & (period - 1)
        return v - period if v >= half else v
    return (w(mv[0]), w(mv[1]))

def scale_mv(mv, scale: int):
    """Mv::scaleMv (Mv.h:176)."""
    def s(v):
        p = scale * v
        return max(MV_MIN, min(MV_MAX, (p + 128 - (p >= 0)) >> 8))
    return (s(mv[0]), s(mv[1]))

# MV storage compression (exponent-4 / mantissa-6); roundMvComp ==
# convertMvFloatToFixed(convertMvFixedToFloat(x)) (UnitTools.cpp:1380-1413)
_MV_EXP_BITS = 4
_MV_MAN_BITS = 6
_MV_MAN_UPPER = (1 << (_MV_MAN_BITS - 1)) - 1
_MV_MAN_LIMIT = 1 << (_MV_MAN_BITS - 1)
_MV_EXP_MASK = (1 << _MV_EXP_BITS) - 1

def round_mv_comp(v: int) -> int:
    sign = -1 if v < 0 else 0
    scale = ((v ^ sign) | _MV_MAN_UPPER).bit_length() - 1 - (_MV_MAN_BITS - 1)
    if scale >= 0:
        rnd = (1 << scale) >> 1
        n = (v + rnd) >> scale
        exponent = scale + ((n ^ sign) >> (_MV_MAN_BITS - 1))
        mantissa = (n & _MV_MAN_UPPER) | (sign << (_MV_MAN_BITS - 1))
    else:
        exponent = 0
        mantissa = v
    if exponent == 0:
        return mantissa
    return (mantissa ^ _MV_MAN_LIMIT) << (exponent - 1)

def _cdiv(a: int, b: int) -> int:
    """C integer division (truncate toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q

def dist_scale_factor(cur_poc, cur_ref_poc, col_poc, col_ref_poc) -> int:
    diff_d = col_poc - col_ref_poc
    diff_b = cur_poc - cur_ref_poc
    if diff_d == diff_b:
        return 4096
    tdb = max(-128, min(127, diff_b))
    tdd = max(-128, min(127, diff_d))
    x = _cdiv(0x4000 + abs(_cdiv(tdd, 2)), tdd)
    return max(-4096, min(4095, (tdb * x + 32) >> 6))


# ---------------------------------------------------------------------------
@dataclass
class MotionInfo:
    is_inter: bool = False
    is_ibc: bool = False
    interdir: int = 0
    use_alt_hpel: bool = False
    slice_idx: int = 0
    mv: list = field(default_factory=lambda: [(0, 0), (0, 0)])
    ref_idx: list = field(default_factory=lambda: [NOT_VALID, NOT_VALID])
    bcw: int = BCW_DEFAULT

    def __eq__(self, other):  # MotionInfo.h:116
        if self.is_inter != other.is_inter or self.is_ibc != other.is_ibc:
            return False
        if self.is_inter:
            if self.slice_idx != other.slice_idx:
                return False
            if self.interdir != other.interdir:
                return False
            if self.interdir != 2:
                if self.ref_idx[0] != other.ref_idx[0] or self.mv[0] != other.mv[0]:
                    return False
            if self.interdir != 1:
                if self.ref_idx[1] != other.ref_idx[1] or self.mv[1] != other.mv[1]:
                    return False
        return True


class MergeCtx:
    def __init__(self, max_cand: int):
        self.interdir = [0] * max_cand
        self.mv = [[(0, 0), (0, 0)] for _ in range(max_cand)]
        self.ref_idx = [[NOT_VALID, NOT_VALID] for _ in range(max_cand)]
        self.bcw = [BCW_DEFAULT] * max_cand
        self.use_alt_hpel = [False] * max_cand
        self.num_valid = max_cand


# ---------------------------------------------------------------------------
# Motion field access

def init_motion_field(dcs) -> None:
    h4 = (dcs.pic_h + 3) >> 2
    w4 = (dcs.pic_w + 3) >> 2
    dcs.mf_inter = np.zeros((h4, w4), dtype=bool)
    dcs.mf_ibc = np.zeros((h4, w4), dtype=bool)
    dcs.mf_interdir = np.zeros((h4, w4), dtype=np.int8)
    dcs.mf_alt_hpel = np.zeros((h4, w4), dtype=bool)
    dcs.mf_slice = np.zeros((h4, w4), dtype=np.int16)
    dcs.mf_mv = np.zeros((h4, w4, 2, 2), dtype=np.int32)
    dcs.mf_refidx = np.full((h4, w4, 2), NOT_VALID, dtype=np.int8)
    dcs.mf_bcw = np.full((h4, w4), BCW_DEFAULT, dtype=np.int8)
    dcs.motion_lut: list[MotionInfo] = []
    dcs.motion_lut_ibc: list[MotionInfo] = []


def get_motion_info(dcs, lx: int, ly: int) -> MotionInfo:
    y4, x4 = ly >> 2, lx >> 2
    return MotionInfo(
        is_inter=bool(dcs.mf_inter[y4, x4]),
        is_ibc=bool(dcs.mf_ibc[y4, x4]),
        interdir=int(dcs.mf_interdir[y4, x4]),
        use_alt_hpel=bool(dcs.mf_alt_hpel[y4, x4]),
        slice_idx=int(dcs.mf_slice[y4, x4]),
        mv=[tuple(int(v) for v in dcs.mf_mv[y4, x4, 0]),
            tuple(int(v) for v in dcs.mf_mv[y4, x4, 1])],
        ref_idx=[int(dcs.mf_refidx[y4, x4, 0]), int(dcs.mf_refidx[y4, x4, 1])],
        bcw=int(dcs.mf_bcw[y4, x4]),
    )


def span_motion_info(dcs, cu) -> None:
    """PU::spanMotionInfo (uniform fill; affine/SbTMVP handled by caller)."""
    b = cu.blocks[0]
    sl = slice(b.y >> 2, b.y1 >> 2), slice(b.x >> 2, b.x1 >> 2)
    is_inter = cu.pred_mode != D.MODE_INTRA and cu.pred_mode != D.MODE_PLT
    dcs.mf_inter[sl] = is_inter
    dcs.mf_ibc[sl] = cu.pred_mode == D.MODE_IBC
    dcs.mf_slice[sl] = dcs.cur_ind_slice_idx
    if is_inter:
        dcs.mf_interdir[sl] = cu.interdir
        dcs.mf_alt_hpel[sl] = cu.imv == IMV_HPEL
        for l in range(2):
            dcs.mf_mv[sl[0], sl[1], l, 0] = cu.mv[l][0]
            dcs.mf_mv[sl[0], sl[1], l, 1] = cu.mv[l][1]
            dcs.mf_refidx[sl[0], sl[1], l] = cu.ref_idx[l]
        dcs.mf_bcw[sl] = cu.bcw_idx
    else:
        dcs.mf_interdir[sl] = 0
        dcs.mf_alt_hpel[sl] = False
        dcs.mf_mv[sl[0], sl[1], :, :] = 0
        dcs.mf_refidx[sl[0], sl[1], :] = NOT_VALID
        dcs.mf_bcw[sl] = BCW_DEFAULT


def save_motion_hmvp(dcs, cu) -> None:
    """CU::saveMotionInHMVP (UnitTools.cpp:306) + addMiToLut
    (CodingStructure.cpp:859)."""
    if cu.geo_flag or cu.affine:
        return
    b = cu.blocks[0]
    mi = get_motion_info(dcs, b.x, b.y)
    mi.bcw = cu.bcw_idx if mi.interdir == 3 else BCW_DEFAULT
    plevel = dcs.sps.log2_parallel_merge_level
    xbr, ybr = b.x + b.w, b.y + b.h
    enable = ((xbr >> plevel) > (b.x >> plevel)) and ((ybr >> plevel) > (b.y >> plevel))
    if cu.pred_mode == D.MODE_IBC or enable:
        lut = dcs.motion_lut_ibc if cu.pred_mode == D.MODE_IBC else dcs.motion_lut
        for idx, m in enumerate(lut):
            if m == mi:
                lut.pop(idx)
                break
        else:
            if len(lut) == MAX_NUM_HMVP_CANDS:
                lut.pop(0)
        lut.append(mi)


# ---------------------------------------------------------------------------
# Neighbour PU lookup with availability restriction

def _get_pu_restricted(dcs, cu, lx: int, ly: int):
    """getPURestricted (CodingStructure.cpp:1584): availability also
    requires the neighbour to precede the current CU in decode order."""
    n = dcs.get_cu_restricted(lx, ly, cu.blocks[0].x, cu.blocks[0].y, D.CH_L)
    if n is None or n.idx > cu.idx:
        return None
    return n


def _get_inter_neighbor(dcs, cu, lx: int, ly: int) -> MotionInfo | None:
    """getPURestricted + CU::isInter check at a luma position."""
    n = _get_pu_restricted(dcs, cu, lx, ly)
    if n is None or n.pred_mode != D.MODE_INTER:
        return None
    return get_motion_info(dcs, lx, ly)


def _is_diff_mer(pos1, pos2, plevel: int) -> bool:
    return (pos1[0] >> plevel) != (pos2[0] >> plevel) or (
        (pos1[1] >> plevel) != (pos2[1] >> plevel)
    )


def _same_cu(cu, lx, ly) -> bool:
    b = cu.blocks[0]
    return b.contains(lx, ly)


# ---------------------------------------------------------------------------
def get_colocated_mvp(dcs, cu, ref_list: int, pos, ref_idx: int,
                      sb_flag: bool = False):
    """PU::getColocatedMVP (UnitTools.cpp:1458) → (found, mv)."""
    sh = dcs.sh
    scale = 16  # 4 * max(1, 4*AMVP_DECIMATION_FACTOR/4) with factor 4
    mask = ~(scale - 1)
    px, py = pos[0] & mask, pos[1] & mask
    col_pic = sh.ref_pics[1 - int(sh.col_from_l0) if sh.is_b else 0][sh.col_ref_idx]
    if col_pic is None:
        return False, (0, 0)
    col_ref_list = ref_list if sh.check_ldc else int(sh.col_from_l0)
    mf = col_pic.motion
    y4, x4 = py >> 2, px >> 2
    if not mf["inter"][y4, x4] or mf["ibc"][y4, x4]:
        return False, (0, 0)
    if cu.pred_mode == D.MODE_IBC:
        return False, (0, 0)
    col_ref_idx = int(mf["refidx"][y4, x4, col_ref_list])
    if sb_flag and not sh.check_ldc:
        col_ref_list = ref_list
        col_ref_idx = int(mf["refidx"][y4, x4, col_ref_list])
        if col_ref_idx < 0:
            return False, (0, 0)
    else:
        if col_ref_idx < 0:
            col_ref_list = 1 - col_ref_list
            col_ref_idx = int(mf["refidx"][y4, x4, col_ref_list])
            if col_ref_idx < 0:
                return False, (0, 0)
    col_slice_idx = int(mf["slice"][y4, x4])
    col_sh = None
    for s in col_pic.slices:
        if s.independent_slice_idx == col_slice_idx:
            col_sh = s
            break
    assert col_sh is not None, "colocated slice not found"
    cur_is_lt = sh.ref_longterm[ref_list][ref_idx]
    col_is_lt = col_sh.ref_longterm[col_ref_list][col_ref_idx]
    if cur_is_lt != col_is_lt:
        return False, (0, 0)
    cmv = (int(mf["mv"][y4, x4, col_ref_list, 0]),
           int(mf["mv"][y4, x4, col_ref_list, 1]))
    cmv = (round_mv_comp(cmv[0]), round_mv_comp(cmv[1]))
    if cur_is_lt:
        return True, clip_storage(cmv)
    cur_poc = sh.poc
    col_poc = col_sh.poc
    col_ref_poc = col_sh.ref_pocs[col_ref_list][col_ref_idx]
    cur_ref_poc = sh.ref_pocs[ref_list][ref_idx]
    ds = dist_scale_factor(cur_poc, cur_ref_poc, col_poc, col_ref_poc)
    if ds == 4096:
        return True, clip_storage(cmv)
    return True, scale_mv(cmv, ds)


def _tmvp_c0_c1(dcs, cu):
    """C0/C1 position computation shared by merge and AMVP TMVP."""
    b = cu.blocks[0]
    pos_rb = (b.x + b.w - 1 - 3, b.y + b.h - 1 - 3)
    c1 = (b.x + (b.w >> 1), b.y + (b.h >> 1))
    c0 = None
    if (pos_rb[0] + 4) < dcs.pic_w and (pos_rb[1] + 4) < dcs.pic_h:
        ctu_mask = dcs.ctu_size - 1
        if (pos_rb[1] & ctu_mask) + 4 < dcs.ctu_size:
            c0 = (pos_rb[0] + 4, pos_rb[1] + 4)
    return c0, c1


# ---------------------------------------------------------------------------
def get_inter_merge_candidates(dcs, cu, mrg_cand_idx: int = -1) -> MergeCtx:
    """PU::getInterMergeCandidates (UnitTools.cpp:917)."""
    sh = dcs.sh
    sps = dcs.sps
    plevel = sps.log2_parallel_merge_level
    max_cand = sps.max_num_merge_cand
    mrg = MergeCtx(max_cand)
    is_b = sh.is_b
    b = cu.blocks[0]
    pos_lt = (b.x, b.y)
    pos_rt = (b.x + b.w - 1, b.y)
    pos_lb = (b.x, b.y + b.h - 1)
    cnt = 0

    def add(mi: MotionInfo, bcw_src=None):
        nonlocal cnt
        mrg.interdir[cnt] = mi.interdir
        mrg.use_alt_hpel[cnt] = mi.use_alt_hpel
        mrg.bcw[cnt] = (bcw_src if bcw_src is not None else BCW_DEFAULT)
        mrg.mv[cnt][0] = mi.mv[0]
        mrg.ref_idx[cnt][0] = mi.ref_idx[0]
        if is_b:
            mrg.mv[cnt][1] = mi.mv[1]
            mrg.ref_idx[cnt][1] = mi.ref_idx[1]
        done = mrg_cand_idx == cnt
        cnt += 1
        return done

    # B1 (above)
    p = (pos_rt[0], pos_rt[1] - 1)
    mi_above = None
    avail_b1 = False
    n = _get_pu_restricted(dcs, cu, p[0], p[1])
    if (n is not None and _is_diff_mer(pos_lt, p, plevel) and not _same_cu(cu, *p)
            and n.pred_mode == D.MODE_INTER):
        avail_b1 = True
        mi_above = get_motion_info(dcs, *p)
        if add(mi_above, n.bcw_idx if mi_above.interdir == 3 else BCW_DEFAULT):
            mrg.num_valid = cnt
            return mrg
    if cnt == max_cand:
        mrg.num_valid = cnt
        return mrg
    # A1 (left)
    p = (pos_lb[0] - 1, pos_lb[1])
    mi_left = None
    avail_a1 = False
    n = _get_pu_restricted(dcs, cu, p[0], p[1])
    if (n is not None and _is_diff_mer(pos_lt, p, plevel) and not _same_cu(cu, *p)
            and n.pred_mode == D.MODE_INTER):
        avail_a1 = True
        mi_left = get_motion_info(dcs, *p)
        if not avail_b1 or mi_above != mi_left:
            if add(mi_left, n.bcw_idx if mi_left.interdir == 3 else BCW_DEFAULT):
                mrg.num_valid = cnt
                return mrg
    if cnt == max_cand:
        mrg.num_valid = cnt
        return mrg
    # B0 (above-right)
    p = (pos_rt[0] + 1, pos_rt[1] - 1)
    n = _get_pu_restricted(dcs, cu, p[0], p[1])
    if (n is not None and _is_diff_mer(pos_lt, p, plevel)
            and n.pred_mode == D.MODE_INTER):
        mi = get_motion_info(dcs, *p)
        if not avail_b1 or mi_above != mi:
            if add(mi, n.bcw_idx if mi.interdir == 3 else BCW_DEFAULT):
                mrg.num_valid = cnt
                return mrg
    if cnt == max_cand:
        mrg.num_valid = cnt
        return mrg
    # A0 (below-left)
    p = (pos_lb[0] - 1, pos_lb[1] + 1)
    n = _get_pu_restricted(dcs, cu, p[0], p[1])
    if (n is not None and _is_diff_mer(pos_lt, p, plevel)
            and n.pred_mode == D.MODE_INTER):
        mi = get_motion_info(dcs, *p)
        if not avail_a1 or mi != mi_left:
            if add(mi, n.bcw_idx if mi.interdir == 3 else BCW_DEFAULT):
                mrg.num_valid = cnt
                return mrg
    if cnt == max_cand:
        mrg.num_valid = cnt
        return mrg
    # B2 (above-left)
    if cnt < 4:
        p = (pos_lt[0] - 1, pos_lt[1] - 1)
        n = _get_pu_restricted(dcs, cu, p[0], p[1])
        if (n is not None and _is_diff_mer(pos_lt, p, plevel)
                and n.pred_mode == D.MODE_INTER):
            mi = get_motion_info(dcs, *p)
            if (not avail_a1 or mi_left != mi) and (not avail_b1 or mi_above != mi):
                if add(mi, n.bcw_idx if mi.interdir == 3 else BCW_DEFAULT):
                    mrg.num_valid = cnt
                    return mrg
    if cnt == max_cand:
        mrg.num_valid = cnt
        return mrg

    # TMVP
    if dcs.ph.tmvp_enabled and (b.w + b.h > 12):
        c0, c1 = _tmvp_c0_c1(dcs, cu)
        direction = 0
        mvf = [(0, 0), (0, 0)]
        rix = [NOT_VALID, NOT_VALID]
        found, cmv = (get_colocated_mvp(dcs, cu, 0, c0, 0) if c0 else (False, None))
        if not found:
            found, cmv = get_colocated_mvp(dcs, cu, 0, c1, 0)
        if found:
            direction |= 1
            mvf[0] = cmv
            rix[0] = 0
        if is_b:
            found, cmv = (get_colocated_mvp(dcs, cu, 1, c0, 0) if c0 else (False, None))
            if not found:
                found, cmv = get_colocated_mvp(dcs, cu, 1, c1, 0)
            if found:
                direction |= 2
                mvf[1] = cmv
                rix[1] = 0
        if direction != 0:
            mrg.interdir[cnt] = direction
            mrg.bcw[cnt] = BCW_DEFAULT
            mrg.use_alt_hpel[cnt] = False
            mrg.mv[cnt] = mvf
            mrg.ref_idx[cnt] = rix
            if mrg_cand_idx == cnt:
                mrg.num_valid = cnt + 1
                return mrg
            cnt += 1
    if cnt == max_cand:
        mrg.num_valid = cnt
        return mrg

    # HMVP (addMergeHMVPCand, UnitTools.cpp:762)
    max_min1 = max_cand - 1
    if cnt != max_min1:
        lut = dcs.motion_lut
        stop = False
        for mrg_idx in range(1, len(lut) + 1):
            mi = lut[len(lut) - mrg_idx]
            if mrg_idx > 2 or (
                (not avail_a1 or mi_left != mi) and (not avail_b1 or mi_above != mi)
            ):
                mrg.interdir[cnt] = mi.interdir
                mrg.use_alt_hpel[cnt] = mi.use_alt_hpel
                mrg.bcw[cnt] = mi.bcw if mi.interdir == 3 else BCW_DEFAULT
                mrg.mv[cnt][0] = mi.mv[0]
                mrg.ref_idx[cnt][0] = mi.ref_idx[0]
                if is_b:
                    mrg.mv[cnt][1] = mi.mv[1]
                    mrg.ref_idx[cnt][1] = mi.ref_idx[1]
                if mrg_cand_idx == cnt:
                    mrg.num_valid = cnt + 1
                    return mrg
                cnt += 1
                if cnt == max_min1:
                    break
        if cnt < max_min1:
            mrg.use_alt_hpel[cnt] = False

    # pairwise average
    if 1 < cnt < max_cand:
        mrg.mv[cnt] = [(0, 0), (0, 0)]
        mrg.ref_idx[cnt] = [NOT_VALID, NOT_VALID]
        mrg.use_alt_hpel[cnt] = (
            mrg.use_alt_hpel[0] if mrg.use_alt_hpel[0] == mrg.use_alt_hpel[1] else False
        )
        interdir = 0
        for l in range(2 if is_b else 1):
            ri = mrg.ref_idx[0][l]
            rj = mrg.ref_idx[1][l]
            if ri == NOT_VALID and rj == NOT_VALID:
                continue
            interdir += 1 << l
            if ri != NOT_VALID and rj != NOT_VALID:
                mi_, mj = mrg.mv[0][l], mrg.mv[1][l]
                avg = (mi_[0] + mj[0], mi_[1] + mj[1])
                # roundAffineMv(x, y, 1): (v + 1 + (v>=0? 0 : ... )) >> 1
                avg = (_round_affine(avg[0], 1), _round_affine(avg[1], 1))
                mrg.mv[cnt][l] = avg
                mrg.ref_idx[cnt][l] = ri
            elif ri != NOT_VALID:
                mrg.mv[cnt][l] = mrg.mv[0][l]
                mrg.ref_idx[cnt][l] = ri
            else:
                mrg.mv[cnt][l] = mrg.mv[1][l]
                mrg.ref_idx[cnt][l] = rj
        mrg.interdir[cnt] = interdir
        if interdir > 0:
            cnt += 1
    if cnt == max_cand:
        mrg.num_valid = cnt
        return mrg

    # zero candidates
    num_ref = (
        min(sh.num_ref_idx[0], sh.num_ref_idx[1]) if is_b else sh.num_ref_idx[0]
    )
    r = 0
    refcnt = 0
    while cnt < max_cand:
        mrg.interdir[cnt] = 1
        mrg.bcw[cnt] = BCW_DEFAULT
        mrg.mv[cnt][0] = (0, 0)
        mrg.ref_idx[cnt][0] = r
        mrg.use_alt_hpel[cnt] = False
        if is_b:
            mrg.interdir[cnt] = 3
            mrg.mv[cnt][1] = (0, 0)
            mrg.ref_idx[cnt][1] = r
        cnt += 1
        if refcnt == num_ref - 1:
            r = 0
        else:
            r += 1
            refcnt += 1
    mrg.num_valid = cnt
    return mrg


def _round_affine(v: int, shift: int) -> int:
    """roundAffineMv: (v + offset + (v<0)) >> shift with offset = (1<<shift)>>1.
    Reference roundAffineMv (Mv.h): x = (x + nOffset - (x >= 0)) >> nShift ...
    Actually: const int nOffset = 1 << (shift - 1); x = (x + nOffset - (x >= 0 ? 0 : 1) ...
    VTM: x = x >= 0 ? (x + nOffset - 1) >> shift : (x + nOffset) >> shift  — same as
    changePrecision right-shift path.
    """
    off = 1 << (shift - 1)
    return (v + off - 1) >> shift if v >= 0 else (v + off) >> shift


def get_ibc_merge_candidates(dcs, cu, mrg_cand_idx: int = -1) -> MergeCtx:
    """PU::getIBCMergeCandidates (UnitTools.cpp:812): spatial A1/B1 (IBC
    neighbours only), IBC HMVP LUT, zero-BV padding."""
    max_cand = dcs.sps.max_num_ibc_merge_cand
    mrg = MergeCtx(max_cand)
    for i in range(max_cand):
        mrg.interdir[i] = 0
        mrg.ref_idx[i] = [NOT_VALID, NOT_VALID]
    mrg.num_valid = max_cand
    cnt = 0
    b = cu.blocks[0]
    is_gt4x4 = b.w * b.h > 16
    # left A1 at posLB.offset(-1, 0)
    mi_left = None
    nl = _get_pu_restricted(dcs, cu, b.x - 1, b.y1 - 1)
    avail_a1 = nl is not None and nl.pred_mode == D.MODE_IBC
    if is_gt4x4 and avail_a1:
        mi_left = get_motion_info(dcs, b.x - 1, b.y1 - 1)
        mrg.interdir[cnt] = mi_left.interdir
        mrg.mv[cnt][0] = mi_left.mv[0]
        mrg.ref_idx[cnt][0] = mi_left.ref_idx[0]
        if mrg_cand_idx == cnt:
            return mrg
        cnt += 1
    if cnt == max_cand:
        return mrg
    # above B1 at posRT.offset(0, -1)
    mi_above = None
    na = _get_pu_restricted(dcs, cu, b.x1 - 1, b.y - 1)
    avail_b1 = na is not None and na.pred_mode == D.MODE_IBC
    if is_gt4x4 and avail_b1:
        mi_above = get_motion_info(dcs, b.x1 - 1, b.y - 1)
        if not avail_a1 or mi_above != mi_left:
            mrg.interdir[cnt] = mi_above.interdir
            mrg.mv[cnt][0] = mi_above.mv[0]
            mrg.ref_idx[cnt][0] = mi_above.ref_idx[0]
            if mrg_cand_idx == cnt:
                return mrg
            cnt += 1
    if cnt == max_cand:
        return mrg
    # HMVP (addMergeHMVPCand with ibcFlag=true, UnitTools.cpp:762)
    lut = dcs.motion_lut_ibc
    for mrg_idx in range(1, len(lut) + 1):
        mi = lut[len(lut) - mrg_idx]
        if (
            mrg_idx > 2
            or mrg_idx > 1
            or not is_gt4x4
            or (
                (not avail_a1 or mi != mi_left)
                and (not avail_b1 or mi != mi_above)
            )
        ):
            mrg.interdir[cnt] = mi.interdir
            mrg.use_alt_hpel[cnt] = False
            mrg.bcw[cnt] = BCW_DEFAULT
            mrg.mv[cnt][0] = mi.mv[0]
            mrg.ref_idx[cnt][0] = mi.ref_idx[0]
            if dcs.sh.is_b:
                mrg.mv[cnt][1] = mi.mv[1]
                mrg.ref_idx[cnt][1] = mi.ref_idx[1]
            if mrg_cand_idx == cnt:
                return mrg
            cnt += 1
            if cnt == max_cand:
                break
    # zero-BV padding (UnitTools.cpp:903-912)
    while cnt < max_cand:
        mrg.mv[cnt][0] = (0, 0)
        mrg.ref_idx[cnt][0] = MAX_NUM_REF
        mrg.interdir[cnt] = 1
        if mrg_cand_idx == cnt:
            return mrg
        cnt += 1
    return mrg


MAX_NUM_REF = 16


def fill_ibc_mvp_cand(dcs, cu) -> list:
    """PU::fillIBCMvpCand (UnitTools.cpp:1738): first two IBC merge
    candidates, rounded to the BV AMVR precision."""
    mrg = get_ibc_merge_candidates(dcs, cu, AMVP_MAX_NUM_CANDS - 1)
    return [
        round_ibc_prec_internal_2_amvr(mrg.mv[i][0], cu.imv)
        for i in range(AMVP_MAX_NUM_CANDS)
    ]


def set_merge_info(dcs, cu, mrg: MergeCtx, cand_idx: int) -> None:
    """MergeCtx::setMergeInfo (ContextModelling.cpp:324)."""
    cu.regular_merge_flag = not (cu.ciip_flag or cu.geo_flag)
    cu.merge_flag = True
    cu.mmvd_flag = False
    cu.interdir = mrg.interdir[cand_idx]
    cu.imv = IMV_HPEL if (not cu.geo_flag and mrg.use_alt_hpel[cand_idx]) else 0
    cu.merge_idx = cand_idx
    cu.mv = [mrg.mv[cand_idx][0], mrg.mv[cand_idx][1]]
    cu.mvd = [(0, 0), (0, 0)]
    cu.ref_idx = [mrg.ref_idx[cand_idx][0], mrg.ref_idx[cand_idx][1]]
    cu.mvp_idx = [NOT_VALID, NOT_VALID]
    cu.bcw_idx = mrg.bcw[cand_idx] if mrg.interdir[cand_idx] == 3 else BCW_DEFAULT
    restrict_bipred(cu)


MMVD_BASE_MV_NUM = 2
MMVD_MAX_REFINE_NUM = 32
GEO_MAX_NUM_UNI_CANDS = 6


def get_geo_merge_candidates(dcs, cu) -> MergeCtx:
    """PU::getGeoMergeCandidates (UnitTools.cpp:3276) — uni-directional
    candidates extracted from the regular merge list by parity."""
    max_cand = dcs.sps.max_num_merge_cand
    tmp = get_inter_merge_candidates(dcs, cu, -1)
    geo = MergeCtx(GEO_MAX_NUM_UNI_CANDS)
    geo.num_valid = 0
    for i in range(max_cand):
        parity = i & 1
        if tmp.interdir[i] & (1 + parity):
            geo.interdir[geo.num_valid] = 1 + parity
            geo.mv[geo.num_valid][1 - parity] = (0, 0)
            geo.mv[geo.num_valid][parity] = tmp.mv[i][parity]
            geo.ref_idx[geo.num_valid][1 - parity] = -1
            geo.ref_idx[geo.num_valid][parity] = tmp.ref_idx[i][parity]
            geo.num_valid += 1
            if geo.num_valid == GEO_MAX_NUM_UNI_CANDS:
                return geo
            continue
        if tmp.interdir[i] & (2 - parity):
            geo.interdir[geo.num_valid] = 2 - parity
            geo.mv[geo.num_valid][1 - parity] = tmp.mv[i][1 - parity]
            geo.mv[geo.num_valid][parity] = (0, 0)
            geo.ref_idx[geo.num_valid][1 - parity] = tmp.ref_idx[i][1 - parity]
            geo.ref_idx[geo.num_valid][parity] = -1
            geo.num_valid += 1
            if geo.num_valid == GEO_MAX_NUM_UNI_CANDS:
                return geo
    return geo


def span_geo_motion_info(dcs, cu, geo: MergeCtx) -> None:
    """PU::spanGeoMotionInfo (UnitTools.cpp:3334)."""
    from vtm_tpu_torch.common import rom

    c0, c1 = cu.geo_merge_idx
    split_dir = cu.geo_split_dir
    if geo.interdir[c0] == 1 and geo.interdir[c1] == 2:
        bi = (3, [geo.mv[c0][0], geo.mv[c1][1]], [geo.ref_idx[c0][0], geo.ref_idx[c1][1]])
    elif geo.interdir[c0] == 2 and geo.interdir[c1] == 1:
        bi = (3, [geo.mv[c1][0], geo.mv[c0][1]], [geo.ref_idx[c1][0], geo.ref_idx[c0][1]])
    elif geo.interdir[c0] == 1 and geo.interdir[c1] == 1:
        bi = (1, [geo.mv[c1][0], (0, 0)], [geo.ref_idx[c1][0], -1])
    else:
        bi = (2, [(0, 0), geo.mv[c1][1]], [-1, geo.ref_idx[c1][1]])
    gp = rom.get("geoParams")
    g_dis = rom.get("geoDis")
    angle = int(gp[split_dir][0])
    dist_idx = int(gp[split_dir][1])
    is_flip = 13 <= angle <= 27
    dist_x = angle
    dist_y = (dist_x + 8) % 32  # GEO_NUM_ANGLES >> 2 = 8
    b = cu.blocks[0]
    w, h = b.w, b.h
    off_x = (-w) >> 1
    off_y = (-h) >> 1
    if dist_idx > 0:
        if angle % 16 == 8 or (angle % 16 != 0 and h >= w):
            off_y += (dist_idx * h) >> 3 if angle < 16 else -((dist_idx * h) >> 3)
        else:
            off_x += (dist_idx * w) >> 3 if angle < 16 else -((dist_idx * w) >> 3)
    mbw, mbh = w >> 2, h >> 2
    slice_idx = dcs.cur_ind_slice_idx
    y4_0, x4_0 = b.y >> 2, b.x >> 2
    for y in range(mbh):
        lut_y = (((4 * y + off_y) << 1) + 5) * int(g_dis[dist_y])
        for x in range(mbw):
            midx = (((4 * x + off_x) << 1) + 5) * int(g_dis[dist_x]) + lut_y
            mask = 2 if abs(midx) < 32 else ((1 - is_flip) if midx <= 0 else int(is_flip))
            if mask == 2:
                d, mv, ri = bi
            elif mask == 0:
                d = geo.interdir[c0]
                mv = geo.mv[c0]
                ri = geo.ref_idx[c0]
            else:
                d = geo.interdir[c1]
                mv = geo.mv[c1]
                ri = geo.ref_idx[c1]
            yy, xx = y4_0 + y, x4_0 + x
            dcs.mf_inter[yy, xx] = True
            dcs.mf_ibc[yy, xx] = False
            dcs.mf_interdir[yy, xx] = d
            dcs.mf_alt_hpel[yy, xx] = False
            dcs.mf_slice[yy, xx] = slice_idx
            for l in range(2):
                dcs.mf_mv[yy, xx, l, 0] = mv[l][0]
                dcs.mf_mv[yy, xx, l, 1] = mv[l][1]
                dcs.mf_refidx[yy, xx, l] = ri[l]
            dcs.mf_bcw[yy, xx] = BCW_DEFAULT


def get_mmvd_base_mvs(mrg: MergeCtx):
    """PU::getInterMMVDMergeCandidates (UnitTools.cpp:1420)."""
    bases = []
    for k in range(mrg.num_valid):
        r0 = mrg.ref_idx[k][0]
        r1 = mrg.ref_idx[k][1]
        if r0 >= 0 and r1 >= 0:
            bases.append(([mrg.mv[k][0], mrg.mv[k][1]], [r0, r1],
                          mrg.use_alt_hpel[k], mrg.interdir[k], mrg.bcw[k]))
        elif r0 >= 0:
            bases.append(([mrg.mv[k][0], (0, 0)], [r0, -1],
                          mrg.use_alt_hpel[k], mrg.interdir[k], mrg.bcw[k]))
        elif r1 >= 0:
            bases.append(([(0, 0), mrg.mv[k][1]], [-1, r1],
                          mrg.use_alt_hpel[k], mrg.interdir[k], mrg.bcw[k]))
        else:
            bases.append(([(0, 0), (0, 0)], [-1, -1], False,
                          mrg.interdir[k], mrg.bcw[k]))
        if len(bases) == MMVD_BASE_MV_NUM:
            break
    return bases


def set_mmvd_merge_info(dcs, cu, mrg: MergeCtx, cand_idx: int) -> None:
    """MergeCtx::setMmvdMergeCandiInfo (ContextModelling.cpp:355)."""
    sh = dcs.sh
    mv_shift = 2  # MV_FRACTIONAL_BITS_DIFF
    ref_mvd_cands = [1 << mv_shift, 2 << mv_shift, 4 << mv_shift, 8 << mv_shift,
                     16 << mv_shift, 32 << mv_shift, 64 << mv_shift, 128 << mv_shift]
    tmp = cand_idx
    base_idx = (tmp % (MMVD_BASE_MV_NUM * MMVD_MAX_REFINE_NUM)) // MMVD_MAX_REFINE_NUM
    tmp = tmp % MMVD_MAX_REFINE_NUM
    step = tmp // 4
    position = tmp % 4
    offset = ref_mvd_cands[step]
    if dcs.ph.dis_frac_mmvd:
        offset <<= 2
    bases = get_mmvd_base_mvs(mrg)
    base_mv, base_ref, base_alt_hpel, base_dir, base_bcw = bases[base_idx]
    r0, r1 = base_ref

    def off_mv(pos):
        return [(offset, 0), (-offset, 0), (0, offset), (0, -offset)][pos]

    if r0 != -1 and r1 != -1:
        poc0 = sh.ref_pocs[0][r0]
        poc1 = sh.ref_pocs[1][r1]
        cur = sh.poc
        t0 = off_mv(position)
        if (poc0 - cur) == (poc1 - cur):
            t1 = t0
        elif abs(poc1 - cur) > abs(poc0 - cur):
            scale = dist_scale_factor(cur, poc0, cur, poc1)
            t1 = t0
            lt = sh.ref_longterm[0][r0] or sh.ref_longterm[1][r1]
            if lt:
                if (poc1 - cur) * (poc0 - cur) > 0:
                    t0 = t1
                else:
                    t0 = (-t1[0], -t1[1])
            else:
                t0 = scale_mv(t1, scale)
        else:
            scale = dist_scale_factor(cur, poc1, cur, poc0)
            lt = sh.ref_longterm[0][r0] or sh.ref_longterm[1][r1]
            if lt:
                if (poc1 - cur) * (poc0 - cur) > 0:
                    t1 = t0
                else:
                    t1 = (-t0[0], -t0[1])
            else:
                t1 = scale_mv(t0, scale)
        cu.interdir = 3
        cu.mv = [(base_mv[0][0] + t0[0], base_mv[0][1] + t0[1]),
                 (base_mv[1][0] + t1[0], base_mv[1][1] + t1[1])]
        cu.ref_idx = [r0, r1]
    elif r0 != -1:
        t0 = off_mv(position)
        cu.interdir = 1
        cu.mv = [(base_mv[0][0] + t0[0], base_mv[0][1] + t0[1]), (0, 0)]
        cu.ref_idx = [r0, -1]
    else:
        t1 = off_mv(position)
        cu.interdir = 2
        cu.mv = [(0, 0), (base_mv[1][0] + t1[0], base_mv[1][1] + t1[1])]
        cu.ref_idx = [-1, r1]
    cu.mmvd_flag = True
    cu.mmvd_idx = cand_idx
    cu.merge_flag = True
    cu.regular_merge_flag = True
    cu.merge_idx = cand_idx
    cu.mvd = [(0, 0), (0, 0)]
    cu.mvp_idx = [NOT_VALID, NOT_VALID]
    cu.imv = IMV_HPEL if base_alt_hpel else 0
    cu.bcw_idx = base_bcw if base_dir == 3 else BCW_DEFAULT
    cu.mv = [clip_storage(m) if cu.ref_idx[i] >= 0 else m
             for i, m in enumerate(cu.mv)]
    restrict_bipred(cu)


def restrict_bipred(cu) -> None:
    """PU::restrictBiPredMergeCandsOne."""
    if is_bipred_restriction(cu) and cu.interdir == 3:
        cu.interdir = 1
        cu.mv[1] = (0, 0)
        cu.ref_idx[1] = NOT_VALID
        cu.bcw_idx = BCW_DEFAULT


def is_bipred_restriction(cu) -> bool:
    w, h = cu.blocks[0].w, cu.blocks[0].h
    return (w == 4 and h == 4) or (w + h == 12)


# ---------------------------------------------------------------------------
def fill_mvp_cand(dcs, cu, ref_list: int, ref_idx: int) -> list:
    """PU::fillMvpCand (UnitTools.cpp:1770) → [mv0, mv1] (internal prec)."""
    cands: list = []
    if ref_idx < 0:
        return [(0, 0), (0, 0)]
    b = cu.blocks[0]
    pos_lt = (b.x, b.y)
    pos_rt = (b.x + b.w - 1, b.y)
    pos_lb = (b.x, b.y + b.h - 1)

    def try_add(pos):
        mi = _get_inter_neighbor(dcs, cu, *pos)
        if mi is None:
            return False
        cur_ref_poc = dcs.sh.ref_pocs[ref_list][ref_idx]
        for lst in (ref_list, 1 - ref_list):
            ri = mi.ref_idx[lst]
            if ri >= 0 and dcs.sh.ref_pocs[lst][ri] == cur_ref_poc:
                cands.append(mi.mv[lst])
                return True
        return False

    # left: A0 then A1
    if not try_add((pos_lb[0] - 1, pos_lb[1] + 1)):
        try_add((pos_lb[0] - 1, pos_lb[1]))
    # above: B0, B1, B2
    if not try_add((pos_rt[0] + 1, pos_rt[1] - 1)):
        if not try_add((pos_rt[0], pos_rt[1] - 1)):
            try_add((pos_lt[0] - 1, pos_lt[1] - 1))

    cands = [round_trans_prec_internal_2_amvr(m, cu.imv) for m in cands]
    if len(cands) == 2 and cands[0] == cands[1]:
        cands = cands[:1]

    if (dcs.ph.tmvp_enabled
            and len(cands) < AMVP_MAX_NUM_CANDS and (b.w + b.h > 12)):
        c0, c1 = _tmvp_c0_c1(dcs, cu)
        found, cmv = (get_colocated_mvp(dcs, cu, ref_list, c0, ref_idx)
                      if c0 else (False, None))
        if not found:
            found, cmv = get_colocated_mvp(dcs, cu, ref_list, c1, ref_idx)
        if found:
            cands.append(round_trans_prec_internal_2_amvr(cmv, cu.imv))

    if len(cands) < AMVP_MAX_NUM_CANDS:
        # addAMVPHMVPCand (UnitTools.cpp:2266)
        cur_ref_poc = dcs.sh.ref_pocs[ref_list][ref_idx]
        lut = dcs.motion_lut
        n_allowed = min(MAX_NUM_HMVP_AVMPCANDS, len(lut))
        for mrg_idx in range(1, n_allowed + 1):
            if len(cands) >= AMVP_MAX_NUM_CANDS:
                break
            mi = lut[mrg_idx - 1]
            for lst in (ref_list, 1 - ref_list):
                ri = mi.ref_idx[lst]
                if ri >= 0 and cur_ref_poc == dcs.sh.ref_pocs[lst][ri]:
                    cands.append(
                        round_trans_prec_internal_2_amvr(mi.mv[lst], cu.imv)
                    )
                    if len(cands) >= AMVP_MAX_NUM_CANDS:
                        break

    cands = cands[:AMVP_MAX_NUM_CANDS]
    while len(cands) < AMVP_MAX_NUM_CANDS:
        cands.append((0, 0))
    return [round_trans_prec_internal_2_amvr(m, cu.imv) for m in cands]


# ---------------------------------------------------------------------------
def clip_mv_in_pic(mv, lx: int, ly: int, dcs):
    """clipMvInPic (Mv.cpp:56); wraparound not supported yet."""
    assert not dcs.sps.wraparound_enabled if hasattr(dcs.sps, "wraparound_enabled") else True
    shift = MV_FRACTIONAL_BITS_INTERNAL
    offset = 8
    hor_max = (dcs.pic_w + offset - lx - 1) << shift
    hor_min = (-dcs.ctu_size - offset - lx + 1) << shift
    ver_max = (dcs.pic_h + offset - ly - 1) << shift
    ver_min = (-dcs.ctu_size - offset - ly + 1) << shift
    return (
        min(hor_max, max(hor_min, mv[0])),
        min(ver_max, max(ver_min, mv[1])),
    )
