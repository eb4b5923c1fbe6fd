"""Random-access encode at 208x120 with RA's default tools, SAO and ALF,
through vtm_tpu_torch on the CPU: the same bytes and reconstruction as
vtm_tpu's RandomAccessEncoder, every picture's hash verified by the port's
decoder, and the MMVD and GEO preselection batches run through the port's
McBatch (the path that launches vtm_mc_tiles on the card).  The cuda test
holds the card's stream to the CPU's."""

import importlib.util
import sys
from collections import Counter

import numpy as np
import pytest
import torch

from vtm_tpu_torch import testing as T
from vtm_tpu_torch.decoder.declib import Decoder
from vtm_tpu_torch.encoder import enc_lib as E
from vtm_tpu_torch.ops import mc_kernel as MK

SOURCE = ("small208_208x120_420_8", 208, 120)
# I, then one B picture (POC 1, both lists on POC 0)
N_FRAMES = 2
GOP = 2


def frames():
    name, w, h = SOURCE
    return [T.read_source(name, w, h, i) for i in range(N_FRAMES)]


def encoder(mod, **device):
    cfg = mod.EncoderConfig(width=SOURCE[1], height=SOURCE[2], qp=32, sao=True,
                            alf=True, max_mtt_depth_intra=0)
    return mod.RandomAccessEncoder(cfg, gop_size=GOP, **device)


@pytest.fixture
def executes_by_caller(monkeypatch):
    """Counts McBatch.execute calls by the name of the calling function."""
    calls = Counter()
    real = MK.McBatch.execute

    def counting(self):
        calls[sys._getframe(1).f_code.co_name] += 1
        return real(self)

    monkeypatch.setattr(MK.McBatch, "execute", counting)
    return calls


def test_ra_preselection_matches_reference(executes_by_caller):
    if importlib.util.find_spec("jax") is None:
        pytest.skip("the jax reference needs jax")
    from vtm_tpu.encoder import enc_lib as R

    src = frames()
    ref = encoder(R)
    want = ref.encode(src)
    enc = encoder(E, device="cpu")
    assert enc.sps.mmvd and enc.sps.geo
    got = enc.encode(src)
    assert got == want
    for c in range(3):
        np.testing.assert_array_equal(enc.last_recon[c], ref.last_recon[c])
    assert executes_by_caller["_preselect_mmvd"] > 0, executes_by_caller
    assert executes_by_caller["_preselect_geo"] > 0, executes_by_caller
    dec = Decoder(device="cpu")
    pics = dec.decode_stream(got)
    assert len(pics) == N_FRAMES
    assert [hr.ok for hr in dec.hash_results] == [True] * N_FRAMES


@pytest.mark.cuda
def test_ra_encode_on_cuda_goes_through_mc_tiles():
    """On the card: the same bytes as on the CPU, with the preselection MC,
    RMD and filter kernels launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    from vtm_tpu_torch import kernels as KN

    src = frames()
    want = encoder(E, device="cpu").encode(src)
    KN.reset_launch_counts()
    got = encoder(E, device="cuda").encode(src)
    assert got == want
    counts = KN.launch_counts()
    for k in ("vtm_mc_tiles", "vtm_rmd_angular", "vtm_deblock_luma_ver",
              "vtm_sao_apply", "vtm_alf_filter"):
        assert counts[k] > 0, counts
