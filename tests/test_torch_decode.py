"""All-intra decode through vtm_tpu_torch on the CPU.

(a) the port's filter chain on real pictures' captured inputs equals the
    reference chain's packed output bit for bit;
(b) golden all-intra streams decode hash-exact through the port, every
    picture's luma deblocking maps with disjoint filter extents;
(c) the 1080p stream too (slow);
(d) the port decodes with jax unimportable and never loads it;
(e) a missing CUDA device raises instead of giving way.
(Inter and IBC decode: tests/test_torch_inter_decode.py.)
"""

import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from vtm_tpu.decoder import declib as ref_declib
from vtm_tpu.decoder import filters as ref_filters
from vtm_tpu_torch.decoder import app
from vtm_tpu_torch.decoder.declib import Decoder, Picture
from vtm_tpu_torch.ops import filter_chain as FC

import _deblock_maps as DM

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TD = os.path.join(ROOT, "testdata")


def read(name):
    with open(os.path.join(TD, f"{name}.bit"), "rb") as f:
        return f.read()


def decode_port(name, device="cpu"):
    """Decode hash-exact; the luma deblocking maps of every picture meet the
    kernels' precondition, disjoint filter extents (tests/_deblock_maps.py)."""
    dec = Decoder(device=device)
    with DM.recorded_deblock_maps() as maps:
        pics = dec.decode_stream(read(name))
    assert pics and len(dec.hash_results) == len(pics)
    for hr in dec.hash_results:
        assert hr.ok, f"{name}: hash mismatch at POC {hr.poc}"
    DM.assert_luma_extents_disjoint(maps, name)
    return dec, pics


@pytest.mark.parametrize("name", ["ai_full_small208_qp37", "ai_ccalf_cc208_qp32"])
def test_chain_matches_reference_on_captured_pictures(name):
    old = ref_filters.CAPTURE_FILTERS
    ref_filters.CAPTURE_FILTERS = True
    try:
        pics = ref_declib.Decoder().decode_stream(read(name))
    finally:
        ref_filters.CAPTURE_FILTERS = old
    assert pics
    for pic in pics:
        cap = pic.filter_capture["full"]
        planes = [cap["y"], cap["cb"], cap["cr"]]
        dmaps = [None if m is None else
                 types.SimpleNamespace(**dict(zip(FC.DMAP_FIELDS, m)))
                 for m in (cap["dbv"], cap["dbh"])]
        fl = cap["fl"]
        alf_tables = None
        if cap["alf"] is not None:
            alf_tables = dict(args=cap["alf"], has_l=fl[10], has_cb=fl[11],
                              has_cr=fl[12], has_cc1=fl[13], has_cc2=fl[14])
        sao_maps = list(cap["sao"])
        assert FC.chain_flags(3, cap["lmcs"], dmaps, sao_maps, alf_tables) == fl
        packed = FC.run_filter_chain(planes, cap["lmcs"], dmaps, sao_maps,
                                     alf_tables, cap["bd"], cap["sx"], cap["sy"],
                                     torch.device("cpu"))
        assert packed.dtype == torch.int32
        np.testing.assert_array_equal(packed.numpy(), cap["out"])


AI_STREAMS = [
    "ai_min_tiny64_qp27",
    "ai_full_tiny64_qp32",
    "ai_full_small208_qp37",
    "ai_ccalf_cc208_qp32",
    "ai422_small208_qp32",
    "ai444_screen_qp32",
    "ai10_small208_qp32",
    "ai_sclaps_small208_qp32",
    # 10-bit source, adaptive QP, dependent quantisation, QP 27 at 416x240,
    # HRD / VUI, minimal tools, scaling lists, slices, tiles, every intra
    # tool, WPP
    "ai10src_small208_qp27",
    "ai_aqp_small208_qp32",
    "ai_dq_tiny64_qp32",
    "ai_full_bq416_qp27",
    "ai_hrdvui_small208_qp32",
    "ai_min_small208_qp32",
    "ai_min_tiny64_qp37",
    "ai_sclist_small208_qp32",
    "ai_slices_bq416_qp32",
    "ai_tiles_bq416_qp32",
    "ai_tools_small208_qp27",
    "ai_tools_tiny64_qp32",
    "ai_wpp_small208_qp32",
]
# golden streams that no port test held before the tolerant-decode repair:
# each decodes to vtm_tpu's pictures too
REFERENCE_STREAMS = AI_STREAMS[8:] + ["sc_plt_ai_qp27"]


@pytest.mark.parametrize("name", AI_STREAMS)
def test_decode_hash_exact(name):
    dec, pics = decode_port(name)
    assert all(isinstance(p.planes[0], np.ndarray) for p in pics)
    assert all(p.device_planes[0].device.type == "cpu" for p in pics)


@pytest.mark.parametrize("name", REFERENCE_STREAMS)
def test_decode_equals_reference(name):
    """The port's pictures equal vtm_tpu's decode of the same stream."""
    _, pics = decode_port(name)
    ref = ref_declib.Decoder().decode_stream(read(name))
    assert [p.poc for p in pics] == [p.poc for p in ref]
    for p, r in zip(pics, ref):
        for a, b in zip(p.planes, r.planes):
            np.testing.assert_array_equal(a, b)


@pytest.mark.slow
def test_decode_hash_exact_hd1080():
    """The 1080p all-intra stream (LMCS, deblock, SAO, ALF, CC-ALF on)."""
    dec, pics = decode_port("ai_full_hd1080_qp37")
    assert len(pics) == 2 and pics[0].planes[0].shape == (1080, 1920)


def test_decode_without_jax():
    """With jax and the reference package unimportable the port still
    decodes hash-exact, and loads neither."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['vtm_tpu'] = None\n"
        "from vtm_tpu_torch.decoder.declib import Decoder\n"
        "dec = Decoder(device='cpu')\n"
        "pics = dec.decode_stream(open('testdata/ai_full_tiny64_qp32.bit', 'rb').read())\n"
        "assert len(pics) == 2 and [h.ok for h in dec.hash_results] == [True, True]\n"
        "loaded = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'vtm_tpu')"
        " and sys.modules[m] is not None]\n"
        "assert not loaded, loaded\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_cuda_requested_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        Decoder(device="cuda")
    with pytest.raises(RuntimeError):
        app.main(["-b", os.path.join(TD, "ai_min_tiny64_qp27.bit")])


@pytest.mark.cuda
def test_decode_on_cuda_goes_through_the_kernels():
    """On the card: hash-exact decode with the filter stages in kernels
    (this stream has deblocking, ALF and CC-ALF, but no SAO)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    from vtm_tpu_torch import kernels as KN

    KN.reset_launch_counts()
    dec, pics = decode_port("ai_ccalf_cc208_qp32", device="cuda")
    assert all(p.device_planes[0].is_cuda for p in pics)
    counts = KN.launch_counts()
    for name in ("vtm_deblock_luma_ver", "vtm_deblock_chroma_ver",
                 "vtm_alf_classify", "vtm_alf_filter", "vtm_ccalf_filter"):
        assert counts[name] > 0, counts


def test_app_writes_the_golden_output(tmp_path, capsys):
    out = tmp_path / "out.yuv"
    opl = tmp_path / "out.opl"
    rc = app.main(["-b", os.path.join(TD, "ai_full_tiny64_qp32.bit"),
                   "-o", str(out), "--opl", str(opl), "--device", "cpu"])
    assert rc == 0
    with open(os.path.join(TD, "ai_full_tiny64_qp32.dec.yuv"), "rb") as f:
        assert out.read_bytes() == f.read()
    assert len(opl.read_text().splitlines()) == 2
    assert "0 hash mismatches" in capsys.readouterr().out


def test_planes_setter_leaves_the_hash_queue():
    """Replacing a pending picture's planes takes it out of the hash queue,
    so its decode hash is never checked against foreign samples."""
    dec = Decoder(device="cpu")
    pic = Picture(
        poc=0, planes=[np.zeros((8, 8), np.int32)], sps_id=0, pps_id=0)
    pic._pending_packed = torch.arange(64 * 3, dtype=torch.int32)
    pic._decoder = dec
    dec._hash_queue.append(pic)
    pic.planes = [np.ones((8, 8), np.int32)]
    assert dec._hash_queue == [] and pic._decoder is None
    assert pic._pending_packed is None and pic.planes[0].sum() == 64


def test_fetch_unpacks_the_chain_output():
    pic = Picture(
        poc=0, planes=[np.zeros((4, 8), np.int32), np.zeros((2, 4), np.int32),
                       np.zeros((2, 4), np.int32)], sps_id=0, pps_id=0)
    pic._pending_packed = torch.arange(48, dtype=torch.int32)
    y, cb, cr = pic.planes
    np.testing.assert_array_equal(y.ravel(), np.arange(32))
    np.testing.assert_array_equal(cb.ravel(), np.arange(32, 40))
    np.testing.assert_array_equal(cr.ravel(), np.arange(40, 48))
