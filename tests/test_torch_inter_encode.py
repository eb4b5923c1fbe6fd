"""Inter encode through vtm_tpu_torch on the CPU, held to vtm_tpu.

(a) the port's InterEncoder (LDP), LowDelayBEncoder (LDB) and
    RandomAccessEncoder (RA) with device="cpu" write the same bytes and the
    same last reconstruction as vtm_tpu's, and the port's decoder verifies
    every picture's hash;
(b) LDB with picture and CTU rate control, and LDB with the MCTF prefilter,
    write the same bytes as vtm_tpu's;
(c) the inter encoders take their device as IntraEncoder does: a missing
    CUDA device raises.
The RA case with MMVD and GEO preselection at 208x120 is in
test_torch_inter_preselect.py, the encoder app in test_torch_apps.py.
"""

import importlib.util

import numpy as np
import pytest
import torch

from vtm_tpu_torch import testing as T
from vtm_tpu_torch.decoder.declib import Decoder
from vtm_tpu_torch.encoder import enc_lib as E

TINY = ("tiny64_64x64_420_8", 64, 64)

# name -> (encoder class name, frames, constructor keywords, config options)
CASES = {
    "ldp": ("InterEncoder", 3, {}, {}),
    "ldb": ("LowDelayBEncoder", 3, {}, {}),
    "ra_gop4": ("RandomAccessEncoder", 5, dict(gop_size=4), {}),
    "ldb_rate_control": ("LowDelayBEncoder", 4, {},
                         dict(target_bitrate=150_000, frame_rate=30.0, ctu_rc=True)),
    "ldb_mctf": ("LowDelayBEncoder", 4, {}, dict(qp=30, mctf=True)),
}


def _needs_jax():
    if importlib.util.find_spec("jax") is None:
        pytest.skip("the jax reference needs jax")


def tiny_frames(n):
    name, w, h = TINY
    return [T.read_source(name, w, h, i) for i in range(n)]


def make_encoder(mod, case, **device):
    """A fresh encoder of module `mod` for `case`: RandomAccessEncoder
    changes the config it is given, so each side gets its own."""
    cls, _, kw, opts = CASES[case]
    cfg = mod.EncoderConfig(width=TINY[1], height=TINY[2],
                            **{"qp": 32, "max_mtt_depth_intra": 0, **opts})
    return getattr(mod, cls)(cfg, **kw, **device)


def check_decodes(bits, n_frames, enc):
    """The port's decoder verifies every picture's hash, and the picture the
    encoder coded last equals its reconstruction."""
    dec = Decoder(device="cpu")
    pics = dec.decode_stream(bits)
    assert len(pics) == n_frames
    assert len(dec.hash_results) == n_frames
    assert all(hr.ok for hr in dec.hash_results)
    last = next(p for p in pics if p.poc == enc.dcs.sh.poc)
    for c in range(3):
        np.testing.assert_array_equal(last.planes[c], enc.last_recon[c])


@pytest.mark.parametrize("case", list(CASES))
def test_inter_encode_matches_reference(case):
    _needs_jax()
    from vtm_tpu.encoder import enc_lib as R

    frames = tiny_frames(CASES[case][1])
    ref = make_encoder(R, case)
    want = ref.encode(frames)
    enc = make_encoder(E, case, device="cpu")
    got = enc.encode(frames)
    assert got == want
    for c in range(3):
        np.testing.assert_array_equal(enc.last_recon[c], ref.last_recon[c])
    if hasattr(ref, "rc_qps"):
        assert enc.rc_qps == ref.rc_qps
    if case == "ldb_rate_control":
        assert len(set(enc.rc_qps)) >= 2  # the picture QPs were steered
        assert enc._ctu_rc is not None     # the CTU model ran on inter pictures
    check_decodes(got, len(frames), enc)


def test_reference_pictures_carry_device_planes():
    """Each stored reference picture holds its filtered planes as int32
    tensors on the encoder's device, equal to its numpy planes."""
    enc = make_encoder(E, "ldp", device="cpu")
    enc.encode(tiny_frames(2))
    assert sorted(enc.dpb) == [0, 1]
    for pic in enc.dpb.values():
        for plane, dev in zip(pic.planes, pic.device_planes):
            assert dev.dtype == torch.int32 and dev.device.type == "cpu"
            np.testing.assert_array_equal(dev.numpy(), plane)


def test_cuda_requested_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (E.InterEncoder, E.LowDelayBEncoder, E.RandomAccessEncoder):
        with pytest.raises(RuntimeError, match="cuda"):
            cls(E.EncoderConfig(width=64, height=64))  # the default device is cuda
