"""The port's applications on the CPU, held to vtm_tpu's.

(a) the encoder app picks LDP (IntraPeriod 32), LDB (Frame1 B) and RA
    (GOPSize 4) as the reference app does and writes the same bitstream and
    reconstruction; an inter encode runs with jax and vtm_tpu unimportable;
(b) the bitstream apps (parcat of two InterEncoder segments, SEI removal,
    merge then extract, the merged stream's VPS) give the reference apps'
    bytes, and the port's decoder decodes their output;
(c) common/mcts checks and clips MVs as the reference's does.
"""

import importlib.util
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

from vtm_tpu_torch import testing as T
from vtm_tpu_torch.apps.bitstream_extract import extract_layer
from vtm_tpu_torch.apps.parcat import parcat
from vtm_tpu_torch.apps.sei_removal import remove_sei
from vtm_tpu_torch.apps.stream_merge import merge_streams
from vtm_tpu_torch.bitstream import reader as nalio
from vtm_tpu_torch.common import mcts
from vtm_tpu_torch.decoder import vlc
from vtm_tpu_torch.decoder.declib import Decoder
from vtm_tpu_torch.encoder import app
from vtm_tpu_torch.encoder import enc_lib as E

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TD = os.path.join(ROOT, "testdata")
TINY = os.path.join(TD, "tiny64_64x64_420_8.yuv")
AI_27 = os.path.join(TD, "ai_min_tiny64_qp27.bit")
AI_37 = os.path.join(TD, "ai_min_tiny64_qp37.bit")

# GOP -> the options that make the app pick its encoder
APP_GOPS = {
    "ldp": ["--IntraPeriod=32"],
    "ldb": ["--Frame1=B"],
    "ra": ["--GOPSize=4"],
}


def _needs_jax():
    if importlib.util.find_spec("jax") is None:
        pytest.skip("the jax reference needs jax")


def _needs_golden(*paths):
    if not all(os.path.exists(p) for p in paths):
        pytest.skip("golden streams not generated")


def app_options(gop):
    return ["--InputFile=" + TINY, "--SourceWidth=64", "--SourceHeight=64",
            "--FramesToBeEncoded=3", "--QP=32", "--SEIDecodedPictureHash=1",
            *APP_GOPS[gop]]


@pytest.fixture(scope="module")
def reference_app(tmp_path_factory):
    """gop -> (bitstream, recon) bytes of vtm_tpu's encoder app, made once."""
    done = {}

    def run(gop):
        if gop not in done:
            from vtm_tpu.encoder import app as ref_app

            out = tmp_path_factory.mktemp(f"ref_{gop}")
            bits, rec = out / "o.bit", out / "o.yuv"
            assert ref_app.main(app_options(gop) + [f"--BitstreamFile={bits}",
                                                    f"--ReconFile={rec}"]) == 0
            done[gop] = (bits.read_bytes(), rec.read_bytes())
        return done[gop]

    return run


@pytest.mark.parametrize("gop", list(APP_GOPS))
def test_encoder_app_matches_reference(gop, reference_app, tmp_path):
    _needs_jax()
    want_bits, want_rec = reference_app(gop)
    bits, rec = tmp_path / "o.bit", tmp_path / "o.yuv"
    assert app.main(app_options(gop) + [f"--BitstreamFile={bits}",
                                        f"--ReconFile={rec}", "--device", "cpu"]) == 0
    assert bits.read_bytes() == want_bits
    assert rec.read_bytes() == want_rec


def test_inter_app_without_jax(reference_app, tmp_path):
    """The RA encode of the app, in a process where jax, jaxlib and vtm_tpu
    cannot be imported, writes the reference app's bytes."""
    _needs_jax()
    want_bits, want_rec = reference_app("ra")
    bits, rec = tmp_path / "o.bit", tmp_path / "o.yuv"
    argv = app_options("ra") + [f"--BitstreamFile={bits}", f"--ReconFile={rec}",
                                "--device", "cpu"]
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'vtm_tpu'):\n"
        "    sys.modules[m] = None\n"
        "from vtm_tpu_torch.encoder import app\n"
        f"assert app.main({argv!r}) == 0\n"
        "loaded = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'vtm_tpu')"
        " and sys.modules[m] is not None]\n"
        "assert not loaded, loaded\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "ok"
    assert bits.read_bytes() == want_bits
    assert rec.read_bytes() == want_rec


def ldp_segment(mod, frames, **device):
    cfg = mod.EncoderConfig(width=64, height=64, qp=32, max_mtt_depth_intra=0)
    return mod.InterEncoder(cfg, **device).encode(frames)


def test_parcat_matches_reference(tmp_path):
    """Two LDP segments (frames 0-2 and 3-4, each with its own IDR) stitch
    into the reference parcat's stream, which the port decodes with
    continuous POCs and every hash verified."""
    _needs_jax()
    from vtm_tpu.apps.parcat import parcat as ref_parcat
    from vtm_tpu.encoder import enc_lib as R

    frames = [T.read_source("tiny64_64x64_420_8", 64, 64, i) for i in range(5)]
    paths = {}
    for side, (mod, dev) in {"ref": (R, {}), "port": (E, {"device": "cpu"})}.items():
        paths[side] = []
        for k, seg in enumerate((frames[0:3], frames[3:5])):
            p = tmp_path / f"{side}_s{k}.bit"
            p.write_bytes(ldp_segment(mod, seg, **dev))
            paths[side].append(str(p))
    assert [open(p, "rb").read() for p in paths["port"]] == \
        [open(p, "rb").read() for p in paths["ref"]]
    out = parcat(paths["port"])
    assert out == ref_parcat(paths["ref"])
    dec = Decoder(device="cpu")
    pics = dec.decode_stream(out)
    assert sorted(p.poc for p in pics) == [0, 1, 2, 3, 4]
    assert len(dec.hash_results) == 5 and all(hr.ok for hr in dec.hash_results)


def test_sei_removal_matches_reference():
    _needs_golden(AI_27)
    from vtm_tpu.apps.sei_removal import remove_sei as ref_remove_sei

    with open(AI_27, "rb") as f:
        data = f.read()
    out = remove_sei(data)
    assert out == ref_remove_sei(data)
    assert len(out) < len(data)
    dec = Decoder(device="cpu")
    assert dec.decode_stream(out) and not dec.hash_results  # hashes gone, stream decodes


def test_stream_merge_and_extract_match_reference():
    _needs_golden(AI_27, AI_37)
    from vtm_tpu.apps.bitstream_extract import extract_layer as ref_extract
    from vtm_tpu.apps.stream_merge import merge_streams as ref_merge

    merged = merge_streams([AI_27, AI_37])
    assert merged == ref_merge([AI_27, AI_37])
    for layer, src in ((0, AI_27), (1, AI_37)):
        ext = extract_layer(merged, layer)
        assert ext == ref_extract(merged, layer)
        with open(src, "rb") as f:
            want = Decoder(device="cpu").decode_stream(f.read())
        got = Decoder(device="cpu").decode_stream(ext)
        assert len(got) == len(want)
        for pw, pg in zip(want, got):
            for c in range(3):
                np.testing.assert_array_equal(pg.planes[c], pw.planes[c])


def test_merged_vps_parses():
    """The VPS that stream_merge writes for two layers parses with both
    layers independent, each its own output layer set."""
    _needs_golden(AI_27)
    merged = merge_streams([AI_27, AI_27])
    vps = next(vlc.parse_vps(nal.rbsp)
               for nal in map(nalio.parse_nal, nalio.split_annexb(merged))
               if nal.nal_unit_type == nalio.NAL_VPS)
    assert vps["max_layers"] == 2
    assert vps["all_independent_layers"]
    assert vps["total_num_olss"] >= 1
    assert vps["num_layers_in_ols"][0] == 1


def tile_dcs():
    """256x128 picture of 64x64 CTUs, two tile columns split at x = 128."""
    pps = SimpleNamespace(ctu_to_tile_col=[0, 0, 1, 1], ctu_to_tile_row=[0, 0],
                          tile_col_bd=[0, 2, 4], tile_row_bd=[0, 2])
    sps = SimpleNamespace(ctu_size=64, ctu_size_log2=6)
    return SimpleNamespace(pps=pps, sps=sps, pic_w=256, pic_h=128)


@pytest.mark.parametrize("mv", [(0, 0), (16 << 4, 0), (112 << 4, 0),
                                ((95 << 4) + 8, 0), ((90 << 4) + 8, 0),
                                (-(20 << 4), 3), (0, (100 << 4) + 4)])
def test_mcts_check_mv_matches_reference(mv):
    from vtm_tpu.common import mcts as ref_mcts

    blk = (16, 16, 16, 16)
    assert mcts.check_mv(tile_dcs(), blk, mv) == ref_mcts.check_mv(tile_dcs(), blk, mv)


def test_mcts_clip_matches_reference():
    from vtm_tpu.common import mcts as ref_mcts

    blk, area = (16, 16, 16, 16), (0, 0, 128, 128)
    assert mcts.check_mv(tile_dcs(), blk, (0, 0))
    assert not mcts.check_mv(tile_dcs(), blk, (112 << 4, 0))  # crosses x = 128
    assert not mcts.check_mv(tile_dcs(), blk, ((95 << 4) + 8, 0))  # filter margin
    for mv in ((400 << 4, -100 << 4), (-(300 << 4), 50 << 4), ((3 << 4) + 5, 7)):
        got = mcts.clip_mv_to_area(mv, blk, area)
        assert got == ref_mcts.clip_mv_to_area(mv, blk, area)
        assert mcts.check_mv(tile_dcs(), blk, got)
