"""GOP-parallel encode through vtm_tpu_torch.parallel.gop: segments encoded
in spawned workers and parcat-stitched give the bytes of the in-process
encode and of vtm_tpu's encode_parallel, in every mode, and decode
hash-exact through the port's decoder (twin of
tests/test_parallel.py:test_gop_parallel_encode_bit_exact)."""

import importlib.util

import pytest
import torch

from vtm_tpu_torch import kernels as KN
from vtm_tpu_torch import testing as T
from vtm_tpu_torch.decoder.declib import Decoder
from vtm_tpu_torch.parallel import gop as G

CFGK = dict(width=64, height=64, qp=32, max_mtt_depth_intra=0)
MODES = {"intra": None, "ldp": None, "ldb": None, "ra": dict(gop_size=2)}


def frames(n):
    return [T.read_source("tiny64_64x64_420_8", 64, 64, i) for i in range(n)]


def reference_bits(src, mode, enc_kwargs):
    """vtm_tpu's encode_parallel in segments of 2, in-process (no jax
    start-up in workers)."""
    if importlib.util.find_spec("jax") is None:
        pytest.skip("the jax reference needs jax")
    from vtm_tpu.parallel.gop import encode_parallel

    return encode_parallel(src, dict(CFGK), mode=mode, segment_len=2, workers=1,
                           enc_kwargs=enc_kwargs)


@pytest.fixture
def one_thread_workers(monkeypatch):
    """Spawned workers start with one OpenMP thread (they inherit the
    environment), so that the suite's other processes keep their cores;
    the bytes do not depend on it."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def check_decodes(bits, n):
    dec = Decoder(device="cpu")
    pics = dec.decode_stream(bits)
    assert sorted(p.poc for p in pics) == list(range(n))
    assert len(dec.hash_results) == n
    assert all(hr.ok for hr in dec.hash_results)


@pytest.mark.parametrize("mode", MODES)
def test_gop_parallel_matches_reference(mode, one_thread_workers):
    """Parallel (2 workers) == in-process == vtm_tpu's, 4 frames in two
    segments of 2."""
    src = frames(4)
    kw = MODES[mode]
    par = G.encode_parallel(src, dict(CFGK), mode=mode, segment_len=2, workers=2,
                            enc_kwargs=kw, device="cpu")
    seq = G.encode_parallel(src, dict(CFGK), mode=mode, segment_len=2, workers=1,
                            enc_kwargs=kw, device="cpu")
    assert par == seq  # deterministic across process boundaries
    assert par == reference_bits(src, mode, kw)
    check_decodes(par, 4)


def test_gop_parallel_tail_segment(one_thread_workers):
    """5 frames in segments of 2, 2 and 1 (the last an IDR alone)."""
    src = frames(5)
    par = G.encode_parallel(src, dict(CFGK), mode="ldp", segment_len=2, workers=2,
                            device="cpu")
    assert par == reference_bits(src, "ldp", None)
    check_decodes(par, 5)


def test_gop_parallel_cuda_default_needs_cuda(monkeypatch):
    """The default device is CUDA: without a card the call raises before any
    worker is spawned, and nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    spawned = []
    monkeypatch.setattr(G, "ProcessPoolExecutor",
                        lambda *a, **k: spawned.append(a) or pytest.fail("spawned"))
    with pytest.raises(RuntimeError, match="cuda"):
        G.encode_parallel(frames(4), dict(CFGK), segment_len=2, workers=2)
    assert not spawned


def test_add_launch_counts_folds_another_process_counts():
    saved = KN.launch_counts()
    try:
        KN.reset_launch_counts()
        KN.add_launch_counts({"vtm_mc_tiles": 3, "vtm_alf_filter": 1})
        KN.add_launch_counts({"vtm_mc_tiles": 2})
        counts = KN.launch_counts()
        assert counts["vtm_mc_tiles"] == 5 and counts["vtm_alf_filter"] == 1
        assert sum(counts.values()) == 6
        with pytest.raises(KeyError, match="vtm_nope"):
            KN.add_launch_counts({"vtm_nope": 1})
    finally:
        KN.reset_launch_counts()
        KN.add_launch_counts(saved)


def test_gop_parallel_rejects_device_in_enc_kwargs():
    with pytest.raises(ValueError, match="device"):
        G.encode_parallel(frames(2), dict(CFGK), segment_len=1, workers=1,
                          enc_kwargs=dict(device="cpu"), device="cpu")


@pytest.mark.cuda
def test_gop_parallel_on_cuda_counts_worker_launches():
    """On the card: 2 workers give the CPU's bytes, and the launches the
    workers made are folded into this process's counts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    # 208x120 pictures, on which the encoder's ALF stage launches its
    # kernels (at 64x64 it launches none); the stitched stream is held to
    # the CPU's bytes only, since parcat keeps the first segment's ALF APS
    # alone
    src = [T.read_source("cc208_208x120_420_8", 208, 120, i) for i in range(2)]
    cfgk = dict(width=208, height=120, qp=37, sao=True, alf=True)
    KN.reset_launch_counts()
    got = G.encode_parallel(src, cfgk, mode="intra", segment_len=1, workers=2,
                            device="cuda")
    counts = KN.launch_counts()
    assert got == G.encode_parallel(src, cfgk, mode="intra", segment_len=1,
                                    workers=1, device="cpu")
    assert counts["vtm_rmd_angular"] > 0 and counts["vtm_alf_filter"] > 0, counts
