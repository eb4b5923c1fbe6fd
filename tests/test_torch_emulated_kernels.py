"""The SATD and RMD CUDA sources, built for the CPU by the test-support
emulation of tests/_emu, against their plain torch versions.

No card and no nvcc here, so the kernels themselves run on the chip only
(chip_smoke.py and the `cuda` tests hold them to the plain versions there).
This checks the same C++ — tile dispatch, shared-memory layout, the class
table header, the native column order, the transposed hor group, MIP's
upsampling, the reduction's first argmin — one std::thread per CUDA
thread, on a few positions of every class.  Tolerance 0.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from vtm_tpu.encoder.enc_lib import EncoderConfig
from vtm_tpu.encoder.rmd_tpu import intra_class_list
from vtm_tpu_torch import testing as T
from vtm_tpu_torch.encoder import rmd as RMD
from vtm_tpu_torch.ops import rdcost as RC

PIC_H, PIC_W = 80, 96
CLASSES = intra_class_list(EncoderConfig(width=PIC_W, height=PIC_H))


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("the CPU emulation of the CUDA sources needs g++")
    from _emu import build

    return build.load(str(tmp_path_factory.mktemp("emu")), ["rdcost.cu", "rmd.cu"])


def test_satd_batch(lib):
    rng = np.random.default_rng(31)
    for h, w in [(2, 2), (4, 4), (8, 8), (16, 16), (8, 16), (16, 8), (4, 8),
                 (8, 4), (4, 16), (32, 8), (64, 64), (3, 5)]:
        for bd in (8, 10):
            d = torch.from_numpy(T.satd_diffs(rng, 5, h, w, bd))
            out = torch.full((5,), -1, dtype=torch.int32)
            assert lib.vtm_satd_batch(d.data_ptr(), out.data_ptr(), 5, h, w, None) == 0
            np.testing.assert_array_equal(out.numpy(),
                                          RC.satd_batch_plain(d, h, w).numpy())
    # tiles on which float32 and float64 normalisation differ
    for h, w in [(8, 16), (16, 8), (4, 8), (8, 4)]:
        d = torch.from_numpy(T.satd_f32_cases(rng, h, w, 10))
        out = torch.empty((d.shape[0],), dtype=torch.int32)
        assert lib.vtm_satd_batch(d.data_ptr(), out.data_ptr(), d.shape[0], h, w,
                                  None) == 0
        np.testing.assert_array_equal(out.numpy(),
                                      RC.satd_batch_plain(d, h, w).numpy())


@pytest.mark.parametrize("bd", [8, 10])
def test_rmd_kernels(lib, bd):
    rng = np.random.default_rng(bd)
    src = T.rmd_source(rng, PIC_H, PIC_W, bd)
    sp = torch.from_numpy(np.pad(src, ((1, RMD.PAD_R), (1, RMD.PAD_R)), mode="edge"))
    for w, h in CLASSES:
        xs, ys = (torch.from_numpy(a)
                  for a in T.rmd_positions(rng, 2, PIC_W, PIC_H, w, h))
        for mip in (False, True):
            c = RMD.class_consts(w, h, bd, mip, "cpu")
            out = torch.full((2, c.ncols), -1, dtype=torch.int32)
            red = torch.full((2, 5), -1, dtype=torch.int32)
            pos = (sp.data_ptr(), *sp.shape, xs.data_ptr(), ys.data_ptr(), 2)
            assert lib.vtm_rmd_angular(*pos, c.tab.data_ptr(), w, h, bd,
                                       out.data_ptr(), c.ncols, None) == 0
            if mip:
                assert lib.vtm_rmd_mip(*pos, c.wadj.data_ptr(), c.n_mip, w, h,
                                       bd, out.data_ptr(), c.ncols, None) == 0
            assert lib.vtm_rmd_reduce(out.data_ptr(), 2, c.ncols, 2 * c.n_mip,
                                      red.data_ptr(), None) == 0
            want_out, want_red = RMD.class_costs_plain(sp, xs, ys, c, w, h, bd, mip)
            np.testing.assert_array_equal(out.numpy(), want_out.numpy())
            np.testing.assert_array_equal(red.numpy(), want_red.numpy())
