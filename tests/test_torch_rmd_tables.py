"""The compact RMD class tables of csrc/rmd.cu against the per-sample ones.

The angular kernel reads, per mode, a reference line (the index into C of
ref_m[j]), a base and a tap row per row, and PDPC weights and side offsets
per column (`encoder/rmd.py:_compact_tables`); the plain version reads
per-sample gather indices (`cidx`, `scidx`), the reference's formulation.
Here the compact table is expanded in numpy the way the kernel reads it and
must give those per-sample tables exactly, for every class of the 1080p
class list at bit depths 8 and 10.
"""

import numpy as np
import pytest

from vtm_tpu_torch.encoder import rmd as RMD
from vtm_tpu_torch.encoder.enc_lib import EncoderConfig

CLASSES = RMD.intra_class_list(EncoderConfig(width=1920, height=1080))


def expand(tab: np.ndarray, w: int, h: int):
    """Per group (ver, hor): (first native column, cidx, f, wl, scidx) as
    the kernel reads the compact table `tab`."""
    tab = tab.astype(np.int64)
    assert tab[0] == len(tab) <= RMD.tab_cap(w, h)
    taps = tab[tab[2]:tab[2] + tab[1]].astype(np.int32).view(np.int8)
    taps = taps.reshape(-1, 4).astype(np.int64)  # the first tap lowest
    out = []
    for g, ver in enumerate((True, False)):
        M, col0, o_sym, o_rows, o_pdpc, o_side = tab[4 + 8 * g:10 + 8 * g]
        dh, dw = (h, w) if ver else (w, h)
        ls = RMD.sym_stride(dh, dw)
        sym = tab[o_sym:o_sym + M * ls].reshape(M, ls)
        rows = tab[o_rows:o_rows + M * dh].reshape(M, dh)
        pdpc = tab[o_pdpc:o_pdpc + M * RMD.PDPC_COLS].reshape(M, RMD.PDPC_COLS)
        side = tab[o_side:o_side + 2 * M].reshape(M, 2)
        j = (rows & 0xFFFF)[:, :, None, None] + np.arange(dw)[:, None] + np.arange(4)
        cidx = np.take_along_axis(sym[:, None, None, :], j.reshape(M, dh, 1, -1),
                                  axis=3).reshape(M, dh, dw, 4)
        nc = min(dw, RMD.PDPC_COLS)
        wl = np.zeros((M, dw), np.int64)
        wl[:, :nc] = pdpc[:, :nc] & 0xFF
        soff = np.zeros((M, dw), np.int64)
        soff[:, :nc] = pdpc[:, :nc] >> 8
        r = np.arange(dh)[None, :, None]
        scidx = side[:, 0, None, None] + np.minimum(r + soff[:, None, :],
                                                    side[:, 1, None, None])
        out.append((col0, cidx, taps[rows >> 16], wl, scidx))
    return out


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("w,h", CLASSES)
def test_compact_table_expands_to_the_gather_tables(w, h, bd):
    """cidx (the zero slot past each mode's line included), the taps and the
    PDPC weights equal everywhere; scidx wherever the kernel reads it: every
    column below PDPC_COLS (beyond, the weight is 0 in both forms, asserted,
    so neither reads a side sample that counts)."""
    c = RMD.class_consts(w, h, bd, False, "cpu")
    zslot = RMD.class_tables(w, h, bd)["lc"] - 1
    col, zero_reads = 4, 0
    for g, (col0, cidx, f, wl, scidx) in zip(c.groups, expand(c.tab.numpy(), w, h)):
        assert col0 == col
        col += len(g["modes"])
        np.testing.assert_array_equal(cidx, g["cidx"].numpy())
        np.testing.assert_array_equal(f, g["f"].numpy())
        np.testing.assert_array_equal(wl, g["wl"].numpy())
        nc = min(g["dw"], RMD.PDPC_COLS)
        np.testing.assert_array_equal(scidx[:, :, :nc], g["scidx"].numpy()[:, :, :nc])
        assert not g["wl"][:, nc:].any()
        zero_reads += int((cidx == zslot).sum())
    assert col == RMD.N_ANG
    assert zero_reads  # taps past a mode's line read the zero slot
