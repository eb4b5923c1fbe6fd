"""All-intra encode through vtm_tpu_torch on the CPU.

(a) the port's IntraEncoder(device="cpu") writes the same bytes and the same
    reconstruction as vtm_tpu's IntraEncoder, and the port's decoder decodes
    the stream hash-exact;
(b) the port's deblock_picture, sao_picture and alf_picture equal vtm_tpu's
    on the planes an encode hands them;
(c) the app encodes and writes its recon with jax unimportable;
(d) a missing CUDA device raises.
The inter GOPs of the app are held to the reference in test_torch_apps.py.
"""

import copy
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from vtm_tpu.encoder import enc_lib as ref_enc
from vtm_tpu.encoder.enc_lib import EncoderConfig
from vtm_tpu_torch import testing as T
from vtm_tpu_torch.decoder.declib import Decoder
from vtm_tpu_torch.encoder.enc_lib import IntraEncoder
from vtm_tpu_torch.ops import alf as ALFP
from vtm_tpu_torch.ops import deblock as DBP
from vtm_tpu_torch.ops import sao as SAOP

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (source, width, height, bit depth, EncoderConfig options)
CASES = {
    "tiny64_qp32_mtt2": ("tiny64_64x64_420_8", 64, 64, 8,
                         dict(qp=32, max_mtt_depth_intra=2)),
    "small208_qp32_sao_alf": ("small208_208x120_420_8", 208, 120, 8,
                              dict(qp=32, sao=True, alf=True, max_mtt_depth_intra=1)),
    "cc208_qp37_ccalf": ("cc208_208x120_420_8", 208, 120, 8,
                         dict(qp=37, sao=True, alf=True, ccalf=True)),
    "small208_10bit_mip": ("small208_208x120_420_10", 208, 120, 10,
                           dict(qp=32, bit_depth=10, mip=True)),
}


def _needs_jax():
    if importlib.util.find_spec("jax") is None:
        pytest.skip("the jax reference needs jax")


def _cfg(name):
    _, w, h, _, kw = CASES[name]
    return EncoderConfig(width=w, height=h, **kw)


def _frames(name):
    src, w, h, bd, _ = CASES[name]
    return [T.read_source(src, w, h, 0, bd)]


@pytest.mark.parametrize("name", list(CASES))
def test_encode_matches_reference(name):
    _needs_jax()
    frames = _frames(name)
    ref = ref_enc.IntraEncoder(_cfg(name))
    want = ref.encode(frames)
    enc = IntraEncoder(_cfg(name), device="cpu")
    got = enc.encode(frames)
    assert got == want
    for c in range(3):
        np.testing.assert_array_equal(enc.last_recon[c], ref.last_recon[c])
    dec = Decoder(device="cpu")
    pics = dec.decode_stream(got)
    assert len(pics) == 1 and [hr.ok for hr in dec.hash_results] == [True]
    for c in range(3):
        np.testing.assert_array_equal(pics[0].planes[c], enc.last_recon[c])


@pytest.fixture(scope="module")
def captured():
    """For each filter stage of the port's encode: the planes it was
    handed, the port's output and vtm_tpu's output on the same coding
    structure at the same moment (a screen-content picture at QP 37 with
    SAO, ALF and CC-ALF, where every stage engages)."""
    _needs_jax()
    from vtm_tpu.ops import alf as RALF
    from vtm_tpu.ops import deblock as RDB
    from vtm_tpu.ops import sao as RSAO

    got = {}
    stages = {"deblock": (DBP, "deblock_picture", RDB.deblock_picture),
              "sao": (SAOP, "sao_picture", RSAO.sao_picture),
              "alf": (ALFP, "alf_picture", RALF.alf_picture)}
    reals = {k: getattr(m, n) for k, (m, n, _) in stages.items()}

    def recorder(key):
        def call(dcs, pic, device):
            before = [p.copy() for p in pic.planes]
            ref_pic = copy.copy(pic)
            ref_pic.planes = [p.copy() for p in pic.planes]
            stages[key][2](dcs, ref_pic)
            reals[key](dcs, pic, device)
            got[key] = (before, [p.copy() for p in pic.planes], ref_pic.planes)
        return call

    for key, (mod, name, _) in stages.items():
        setattr(mod, name, recorder(key))
    try:
        cfg = EncoderConfig(width=208, height=120, qp=37, sao=True, alf=True,
                            ccalf=True)
        IntraEncoder(cfg, device="cpu").encode(
            [T.read_source("screen208_208x120_420_8", 208, 120)])
    finally:
        for key, (mod, name, _) in stages.items():
            setattr(mod, name, reals[key])
    assert set(got) == set(stages)
    return got


@pytest.mark.parametrize("stage", ["deblock", "sao", "alf"])
def test_filter_stage_matches_reference(captured, stage):
    before, port_out, ref_out = captured[stage]
    for c in range(3):
        np.testing.assert_array_equal(port_out[c], ref_out[c])
    assert any(not np.array_equal(port_out[c], before[c]) for c in range(3)), \
        f"{stage} left the picture as it was"


def test_app_round_trip_without_jax(tmp_path):
    """python -m vtm_tpu_torch.encoder.app --device cpu with jax unimportable
    writes the reference app's stream and a recon file equal to the
    reference's, and never loads a jax module."""
    _needs_jax()
    from vtm_tpu.encoder import app as ref_app

    src = os.path.join(ROOT, "testdata", "tiny64_64x64_420_8.yuv")
    opts = ["--InputFile=" + src, "--SourceWidth=64", "--SourceHeight=64",
            "--QP=32", "--IntraPeriod=1", "--FramesToBeEncoded=1",
            "--SEIDecodedPictureHash=1"]
    ref_bits, ref_rec = tmp_path / "ref.bit", tmp_path / "ref.yuv"
    assert ref_app.main(opts + [f"--BitstreamFile={ref_bits}",
                                f"--ReconFile={ref_rec}"]) == 0
    bits, rec = tmp_path / "port.bit", tmp_path / "port.yuv"
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['vtm_tpu'] = None\n"
        "from vtm_tpu_torch.encoder import app\n"
        f"rc = app.main({opts + [f'--BitstreamFile={bits}', f'--ReconFile={rec}', '--device', 'cpu']!r})\n"
        "assert rc == 0\n"
        "loaded = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'vtm_tpu')"
        " and sys.modules[m] is not None]\n"
        "assert not loaded, loaded\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "ok"
    assert bits.read_bytes() == ref_bits.read_bytes()
    assert rec.read_bytes() == ref_rec.read_bytes()


def test_cuda_requested_without_cuda_raises(monkeypatch):
    from vtm_tpu_torch.encoder.rmd import FrameRMD

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = EncoderConfig(width=64, height=64)
    with pytest.raises(RuntimeError, match="cuda"):
        IntraEncoder(cfg, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        FrameRMD(np.zeros((64, 64), np.int32), cfg, 1.0, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        IntraEncoder(cfg)  # the default device is cuda


@pytest.mark.cuda
def test_encode_on_cuda_goes_through_the_kernels():
    """On the card: the same bytes as on the CPU, with the RMD and filter
    kernels launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    from vtm_tpu_torch import kernels as KN

    name = "small208_qp32_sao_alf"
    want = IntraEncoder(_cfg(name), device="cpu").encode(_frames(name))
    KN.reset_launch_counts()
    got = IntraEncoder(_cfg(name), device="cuda").encode(_frames(name))
    assert got == want
    counts = KN.launch_counts()
    for k in ("vtm_rmd_angular", "vtm_rmd_reduce", "vtm_deblock_luma_ver",
              "vtm_alf_classify", "vtm_alf_filter"):
        assert counts[k] > 0, counts
