"""Inter, IBC, DMVR and BDOF decode through vtm_tpu_torch on the CPU.

(a) golden inter and IBC streams decode hash-exact through
    Decoder(device="cpu"), every picture's luma deblocking maps with
    disjoint filter extents, the flagship RA stream through every batched
    path (MC, DMVR search, final FIR, BDOF);
(b) the DMVR-refined motion field equals the reference decoder's, and
    differs without the write-back;
(c) an RA stream with DMVR and BDOF decodes with jax unimportable;
(d) McBatch refuses a reference plane that is not on its device;
(e) the app prints the per-syntax bit statistics with --stats.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from vtm_tpu.decoder import declib as ref_declib
from vtm_tpu_torch.decoder import app, filters, refine
from vtm_tpu_torch.decoder.declib import Decoder
from vtm_tpu_torch.ops import mc_kernel as MK
from vtm_tpu_torch.ops import refine_kernel as RK

import _deblock_maps as DM

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TD = os.path.join(ROOT, "testdata")
FLAGSHIP = "ra_full_bq416_qp37"

# tests/test_decode_conformance.py's INTER_STREAMS
INTER_STREAMS = [
    "ld_min_tiny64_qp32",
    "ld_min_small208_qp32",
    "ld_db_small208_qp32",
    "ld_tmvp_small208_qp32",
    "ld_imv_small208_qp32",
    "ld_mmvd_small208_qp32",
    "ld_affine_small208_qp32",
    "ld_sbtmvp_small208_qp32",
    "ld_sbt_small208_qp32",
    "ldb_min_small208_qp32",
    "ldb_tools_small208_qp32",
    "ldb_full_small208_qp32",
    "ra_min_small208_qp32",
    "ra_dmvr_small208_qp32",
    "ra_full_small208_qp32",
]
# weighted prediction, IBC (inter, all-intra, with palette, 4:4:4 with
# ACT), palette alone, 10-bit RA, WPP and the flagship
MORE_STREAMS = ["wp_fade_ldb_qp32", "sc_ibc_ldb_qp32", "sc_ibc_ai_qp27",
                "sc_ibc_full_ai_qp32", "sc_ibcplt_ai_qp32", "sc_plt_ai_qp27",
                "act444_screen_qp32",
                "ra10_small208_qp32", "ld_wpp_small208_qp32",
                "ra_wpp_bq416_qp37", FLAGSHIP]


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


@pytest.mark.parametrize("name", INTER_STREAMS + MORE_STREAMS)
def test_decode_hash_exact(name):
    decode_port(name)


def test_flagship_runs_every_batched_path(monkeypatch):
    """ra_full_bq416_qp37 (416x240, every inter tool on) reaches the MC
    batch, the DMVR search and final FIR, and both BDOF paths."""
    calls = {}

    def count(mod, name):
        real = getattr(mod, name)

        def wrapped(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return real(*a, **kw)
        monkeypatch.setattr(mod, name, wrapped)

    for name in ("mc_tiles_pair",):
        count(MK, name)
    for name in ("dmvr_search", "dmvr_final_pack", "bdof_blend_batch"):
        count(RK, name)
    for name in ("dmvr_batch", "bdof_batch"):
        count(refine, name)
    dec, pics = decode_port(FLAGSHIP)
    assert len(pics) == 8 and pics[0].planes[0].shape == (240, 416)
    assert set(calls) == {"mc_tiles_pair", "dmvr_search", "dmvr_final_pack",
                          "bdof_blend_batch", "dmvr_batch", "bdof_batch"}, calls


def test_dmvr_motion_field_matches_reference(monkeypatch):
    """The DMVR write-back (setRefinedMotionField) leaves every picture's
    4x4 motion field equal to the reference decoder's; without it the
    field of a refined picture differs."""
    name = "ra_dmvr_small208_qp32"
    ref = {p.poc: p.dcs.mf_mv for p in ref_declib.Decoder().decode_stream(read(name))}
    _, pics = decode_port(name)
    assert sorted(ref) == sorted(p.poc for p in pics)
    for p in pics:
        np.testing.assert_array_equal(p.dcs.mf_mv, ref[p.poc])
    monkeypatch.setattr(filters, "store_refined_motion", lambda dcs: None)
    stale = Decoder(device="cpu").decode_stream(read(name))
    assert any(not np.array_equal(p.dcs.mf_mv, ref[p.poc]) for p in stale)


def test_inter_decode_without_jax():
    """With jax and the reference package unimportable the port decodes the
    flagship RA stream (every inter tool, DMVR and BDOF) hash-exact, through
    the batched DMVR, and loads neither."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['vtm_tpu'] = None\n"
        "from vtm_tpu_torch.decoder import refine\n"
        "from vtm_tpu_torch.decoder.declib import Decoder\n"
        "real, n = refine.dmvr_batch, []\n"
        "refine.dmvr_batch = lambda *a: n.append(1) or real(*a)\n"
        "dec = Decoder(device='cpu')\n"
        "pics = dec.decode_stream(open('testdata/ra_full_bq416_qp37.bit', 'rb').read())\n"
        "assert len(pics) == 8 and all(h.ok for h in dec.hash_results)\n"
        "assert len(dec.hash_results) == 8 and n\n"
        "loaded = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'vtm_tpu')"
        " and sys.modules[m] is not None]\n"
        "assert not loaded, loaded\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_mc_batch_refuses_a_plane_on_another_device():
    """McBatch takes its device from the decoder: a host array or a tensor
    elsewhere is refused, not moved."""
    batch = MK.McBatch(8, "cpu")
    coeffs = np.array([0, 0, 0, 64, 0, 0, 0, 0])
    args = (0, 0, 8, 8, coeffs, coeffs, False, True, True)
    with pytest.raises(ValueError, match="ndarray"):
        batch.add_block(np.zeros((16, 16), np.int32), *args)
    with pytest.raises(ValueError, match="meta"):
        batch.add_block(torch.zeros((16, 16), dtype=torch.int32, device="meta"), *args)
    batch.add_block(torch.zeros((16, 16), dtype=torch.int32), *args)
    assert batch.n[True] == 4


def test_app_prints_bit_statistics(capsys):
    rc = app.main(["-b", os.path.join(TD, "ld_min_tiny64_qp32.bit"), "--stats",
                   "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0 and "0 hash mismatches" in out
    assert "syntax (ctx set)" in out and "(bypass bins)" in out
    total = [ln for ln in out.splitlines() if ln.startswith("TOTAL")]
    assert len(total) == 1 and float(total[0].split()[-1]) > 0


@pytest.mark.cuda
def test_inter_decode_on_cuda_goes_through_the_kernels():
    """On the card: the flagship RA stream hash-exact, with MC, DMVR search,
    final FIR and BDOF in kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    from vtm_tpu_torch import kernels as KN

    KN.reset_launch_counts()
    decode_port(FLAGSHIP, device="cuda")
    counts = KN.launch_counts()
    for name in ("vtm_mc_tiles", "vtm_dmvr_search", "vtm_fir_blocks",
                 "vtm_bdof_blend"):
        assert counts[name] > 0, counts
