"""The port's intra predictor inputs and outputs against the reference's
scalar code, on the CPU.

(a) `ops/intra.py:pred_mip` (one matrix product, array up-sampling) equals
    the reference's loops for every size id, mode, transposition and bit
    depth, with boundaries at 0, at the maximum and seeded at random;
(b) `CuReconstructor._fill_ref_lengths` (availability gathered from the
    coding structure's maps, padding as one forward fill) equals the
    reference's per-unit version on every call of a decode of golden
    streams with slices, tiles, WPP, 4:2:2, 4:4:4, ISP, MRL, CCLM and CIIP.
"""

import os

import numpy as np
import pytest

from vtm_tpu.decoder import dec_cu as ref_dec_cu
from vtm_tpu.ops import intra as ref_intra
from vtm_tpu_torch import trace
from vtm_tpu_torch.decoder import dec_cu
from vtm_tpu_torch.decoder.declib import Decoder
from vtm_tpu_torch.ops import intra

TD = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "testdata")

MIP_SHAPES = [(4, 4), (4, 8), (8, 4), (8, 8), (4, 16), (16, 4), (16, 16),
              (8, 32), (32, 8), (16, 64), (64, 16), (64, 64)]
MIP_MODES = {0: 16, 1: 8, 2: 6}


@pytest.mark.parametrize("transpose", [False, True], ids=["plain", "transposed"])
@pytest.mark.parametrize("bit_depth", [8, 10])
@pytest.mark.parametrize("w,h", MIP_SHAPES, ids=[f"{w}x{h}" for w, h in MIP_SHAPES])
def test_pred_mip_matches_reference(w, h, bit_depth, transpose):
    size_id = intra.mip_size_id(w, h)
    maxv = (1 << bit_depth) - 1
    rng = np.random.default_rng(w * 1000 + h * 10 + bit_depth)
    bounds = [(np.zeros(w, np.int64), np.zeros(h, np.int64)),
              (np.full(w, maxv, np.int64), np.full(h, maxv, np.int64)),
              (np.zeros(w, np.int64), np.full(h, maxv, np.int64))]
    bounds += [(rng.integers(0, maxv + 1, w), rng.integers(0, maxv + 1, h))
               for _ in range(3)]
    for mode in range(MIP_MODES[size_id]):
        for top, left in bounds:
            want = ref_intra.pred_mip(top, left, w, h, mode, transpose, bit_depth)
            got = intra.pred_mip(top, left, w, h, mode, transpose, bit_depth)
            assert got.shape == (h, w)
            np.testing.assert_array_equal(got, want, err_msg=f"mode {mode}")


REF_STREAMS = ["ai_slices_bq416_qp32", "ai_tiles_bq416_qp32", "ai_wpp_small208_qp32",
               "ai422_small208_qp32", "ai444_screen_qp32", "ai_tools_small208_qp27",
               "ra_full_small208_qp32"]


@pytest.mark.parametrize("name", REF_STREAMS)
def test_fill_ref_lengths_matches_reference(name, monkeypatch):
    port_fill = dec_cu.CuReconstructor._fill_ref_lengths
    calls = {"fill": 0}

    def check(recon, tu_b, cu, comp, mrl, pred_size, pred_hsize):
        top, left = port_fill(recon, tu_b, cu, comp, mrl, pred_size, pred_hsize)
        # the reference's per-unit version, run on the port's reconstructor
        want_top, want_left = ref_dec_cu.CuReconstructor._fill_ref_lengths(
            recon, tu_b, cu, comp, mrl, pred_size, pred_hsize)
        cs = recon.cs
        where = (f"{name}: comp {comp} at ({tu_b.x}, {tu_b.y}) {tu_b.w}x{tu_b.h} "
                 f"mrl {mrl}, slice {cs.cur_slice_idx}, wpp {cs.sps.entropy_coding_sync}")
        np.testing.assert_array_equal(top, want_top, err_msg=where)
        np.testing.assert_array_equal(left, want_left, err_msg=where)

    def checked(self, tu_b, cu, comp, mrl, pred_size, pred_hsize):
        # the fill reads the state and changes nothing, so each call is also
        # checked on the same state at the other reference lines (MRL), with
        # the WPP rule flipped and from the slice before: rules the streams
        # alone exercise rarely
        cs, sps = self.cs, self.cs.sps
        for line in sorted({mrl, 1, 2} if comp == 0 else {mrl}):
            check(self, tu_b, cu, comp, line, pred_size, pred_hsize)
        wpp, slice_idx = sps.entropy_coding_sync, cs.cur_slice_idx
        try:
            sps.entropy_coding_sync = not wpp
            check(self, tu_b, cu, comp, mrl, pred_size, pred_hsize)
            sps.entropy_coding_sync = wpp
            if slice_idx > 0:
                cs.cur_slice_idx = slice_idx - 1
                check(self, tu_b, cu, comp, mrl, pred_size, pred_hsize)
        finally:
            sps.entropy_coding_sync, cs.cur_slice_idx = wpp, slice_idx
        calls["fill"] += 1
        return port_fill(self, tu_b, cu, comp, mrl, pred_size, pred_hsize)

    def count(counter, n=1):
        calls[counter] = calls.get(counter, 0) + n

    monkeypatch.setattr(dec_cu.CuReconstructor, "_fill_ref_lengths", checked)
    # the program's counters, as a profiler session would record them
    monkeypatch.setattr(trace, "count", count)
    with open(os.path.join(TD, f"{name}.bit"), "rb") as f:
        bits = f.read()
    dec = Decoder(device="cpu")
    pics = dec.decode_stream(bits)
    assert pics and all(hr.ok for hr in dec.hash_results)
    assert calls["fill"] > 0 and calls.get("intra.ref_partial", 0) > 0
