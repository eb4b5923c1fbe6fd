"""Whole-picture in-loop filter chain on a torch device.

Counterpart of vtm_tpu/ops/filter_chain.py with the decode mesh off.  The
order is DecLib::executeLoopFilters (DecLib.cpp:596): LMCS inverse luma
mapping -> deblocking (VER, HOR) -> SAO -> ALF/CC-ALF.  Every stage's
parameters are sample-independent and built on the host by vtm_tpu's
build_* functions; `maps_to_torch` moves them to the device, and
`chain_body` runs the stages through the port's kernel wrappers (CUDA
kernels on a GPU, their plain versions on the CPU).  The three planes come back packed into one
flat int32 tensor, laid out as the reference packs them.
"""

from __future__ import annotations

import numpy as np
import torch

from vtm_tpu_torch.ops import alf_kernel as AK
from vtm_tpu_torch.ops import deblock_kernel as DK
from vtm_tpu_torch.ops import edge_pad
from vtm_tpu_torch.ops import sao_kernel as SK

# PicDeblockMaps fields in deblock_dir's argument order
DMAP_FIELDS = ("l_active", "l_tc", "l_beta", "l_maxp", "l_maxq", "l_nop",
               "l_noq", "cb_active", "cb_tc", "cb_beta", "cr_active", "cr_tc",
               "cr_beta", "c_large", "c_nop", "c_noq", "c_horctb")

_I32 = np.iinfo(np.int32)


def to_device(a, device) -> torch.Tensor:
    """A numpy bool or integer array as a bool or int32 tensor on `device`."""
    a = np.asarray(a)
    if a.dtype == np.bool_:
        a = np.ascontiguousarray(a)
    elif np.issubdtype(a.dtype, np.integer):
        if a.size and (a.min() < _I32.min or a.max() > _I32.max):
            raise OverflowError(f"values of a {a.dtype} array exceed int32")
        a = np.ascontiguousarray(a, dtype=np.int32)
    else:
        raise TypeError(f"filter state must be bool or integer, got {a.dtype}")
    if not a.flags.writeable:  # torch.from_numpy wants a writable buffer
        a = a.copy()
    return torch.from_numpy(a).to(device)


def maps_to_torch(dmaps, sao_maps, alf_tables, device):
    """Per-picture filter state as the chain's tensors on `device`, in the
    argument order of run_filter_chain: (dbv, dbh, sao, alf).

    dmaps: [maps_ver, maps_hor] (vtm_tpu.ops.deblock.PicDeblockMaps) or
    None -> dbv, dbh: 17 tensors each, or None;
    sao_maps: per-component (type_map, ctu_map, offsets, valid) or None
    -> sao: a list of 3 such 4-tuples of tensors (None where inactive);
    alf_tables: dict from build_alf_tables or None -> alf: its 22 tables."""
    def dmap(m):
        if m is None:
            return None
        return tuple(to_device(getattr(m, f), device) for f in DMAP_FIELDS)

    dbv = dmap(dmaps[0]) if dmaps else None
    dbh = dmap(dmaps[1]) if dmaps else None
    sao = [None, None, None]
    for c, a in enumerate(sao_maps or ()):
        if a is not None:
            sao[c] = tuple(to_device(x, device) for x in a)
    alf = None
    if alf_tables is not None:
        alf = tuple(to_device(a, device) for a in alf_tables["args"])
    return dbv, dbh, sao, alf


def chain_flags(n_comp, lmcs_lut, dmaps, sao_maps, alf_tables) -> tuple:
    """The static stage flags of the reference's chain (its `fl`)."""
    def dflags(m):
        if m is None:
            return (False, False, False)
        return (bool(m.l_active.any()),
                n_comp > 1 and bool(m.cb_active.any()),
                n_comp > 1 and bool(m.cr_active.any()))

    fv = dflags(dmaps[0] if dmaps else None)
    fh = dflags(dmaps[1] if dmaps else None)
    sflags = tuple(bool(sao_maps) and sao_maps[c] is not None for c in range(3))
    aflags = (False,) * 5
    if alf_tables is not None:
        aflags = tuple(bool(alf_tables[k]) for k in
                       ("has_l", "has_cb", "has_cr", "has_cc1", "has_cc2"))
    return (lmcs_lut is not None,) + fv + fh + sflags + aflags


def chain_body(y, cb, cr, lmcs_lut, dbv, dbh, sao, alf,
               bd: int, sx: int, sy: int, fl: tuple) -> torch.Tensor:
    """The chain on device tensors; returns [Y, Cb, Cr] flattened and packed
    (for 4:0:0 the caller passes y as cb and cr, as the reference does)."""
    (f_lmcs, dvl, dvcb, dvcr, dhl, dhcb, dhcr,
     s0, s1, s2, a_l, a_cb, a_cr, a_cc1, a_cc2) = fl
    if f_lmcs:
        # jax clamps the gather index; the reconstruction is already in range
        y = lmcs_lut[y.to(torch.int64).clamp(0, lmcs_lut.shape[0] - 1)]
    if dvl or dvcb or dvcr:
        y, cb, cr = DK.deblock_dir(
            y, cb, cr, *dbv, bit_depth=bd, hor=False,
            has_l=dvl, has_cb=dvcb, has_cr=dvcr, sx=sx, sy=sy)
    if dhl or dhcb or dhcr:
        y, cb, cr = DK.deblock_dir(
            y, cb, cr, *dbh, bit_depth=bd, hor=True,
            has_l=dhl, has_cb=dhcb, has_cr=dhcr, sx=sx, sy=sy)
    if s0:
        y = SK.sao_apply(y, *sao[0], bit_depth=bd)
    if s1:
        cb = SK.sao_apply(cb, *sao[1], bit_depth=bd)
    if s2:
        cr = SK.sao_apply(cr, *sao[2], bit_depth=bd)
    if a_l or a_cb or a_cr or a_cc1 or a_cc2:
        y_pad = edge_pad(y, AK.PAD, AK.PAD)
        y, cb, cr = AK.alf_all(
            y_pad, cb, cr, *alf, bit_depth=bd, sx=sx, sy=sy,
            has_l=a_l, has_cb=a_cb, has_cr=a_cr,
            has_cc1=a_cc1, has_cc2=a_cc2)
    return torch.cat([y.reshape(-1), cb.reshape(-1), cr.reshape(-1)])


def run_filter_chain(planes, lmcs_lut, dmaps, sao_maps, alf_tables,
                     bit_depth: int, sx: int, sy: int,
                     device: torch.device) -> torch.Tensor | None:
    """Upload the reconstruction and the filter state to `device` and run
    the chain.  Returns the packed output (left on the device), or None if
    every stage is off.

    planes: the picture's numpy planes (int32); the other arguments as in
    vtm_tpu.ops.filter_chain.run_filter_chain."""
    n_comp = len(planes)
    fl = chain_flags(n_comp, lmcs_lut, dmaps, sao_maps, alf_tables)
    if not any(fl):
        return None
    y = to_device(planes[0], device)
    cb = to_device(planes[1], device) if n_comp > 1 else y
    cr = to_device(planes[2], device) if n_comp > 2 else y
    dbv, dbh, sao, alf = maps_to_torch(dmaps, sao_maps, alf_tables, device)
    lut = to_device(lmcs_lut, device) if lmcs_lut is not None else None
    return chain_body(y, cb, cr, lut, dbv, dbh, sao, alf,
                      bit_depth, sx, sy, fl)
