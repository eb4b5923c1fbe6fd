"""Whole runs of the all-intra encode cell on the CPU, past the harness's
look for a card: sound runs are correct, and the control and every planted
fault are not.  Then the seed's part (the order of the frames only), the
reference's record of how it was made, and the yardstick's frozen copy of
the RMD count against the program's.

The whole runs encode a cycle of two of the configuration's frames (a
picture takes tens of seconds on the CPU); the card's runs encode all 8."""

import hashlib
import json
import os

import pytest

from vvcbench import harness, manifest, rmd_work, vtm_reference
from vvcbench.runners import encode_frames

CELL = "ai-classD-encode"
SEED = 2**31 + 12350  # wider than 32 signed bits, as the runs' seeds are
MADE_LOG = os.path.join(manifest.HERE, "streams", "ai_enc_bq416_qp37.made.log")
# the host spans' metrics: the CPU has no device trace
HOST_METRICS = {"rd_ms_per_picture.encode", "rmd_ms_per_picture.encode",
                "filter_ms_per_picture.encode"}


@pytest.fixture(scope="module")
def man():
    return manifest.load()


@pytest.fixture
def two_frames(monkeypatch):
    """The cell's configuration with its first two frames' references only."""
    orig = manifest.config

    def config(man, name):
        cfg = orig(man, name)
        cfg["streams"] = cfg["streams"][:2]
        return cfg
    monkeypatch.setattr(manifest, "config", config)


@pytest.mark.parametrize("traced", [False, True], ids=["trace0", "trace1"])
def test_sound_run_is_correct(man, two_frames, traced):
    from vtm_tpu_torch.encoder.rmd import FrameRMD

    fetch = FrameRMD.__dict__["_fetch"]
    res = harness.run_cell(man, CELL, SEED, 0.1, traced, device="cpu")
    assert FrameRMD.__dict__["_fetch"] is fetch  # the hooks put back what they wrapped
    assert res["correct"] is True
    assert res["attempted"] == 2 and res["failed"] == 0
    assert res["checks"] == {"pictures_wrong": {"value": 0, "limit": 0}}
    assert list(res)[-1] == "checks"
    want = {m["name"] for m in manifest.metrics_of(man, CELL, traced)}
    if traced:
        assert set(res["metrics"]) == HOST_METRICS | {"picture_ms_p95.encode"} < want
        assert "breakdown" in res and res["device"]["window_s"] > 0
    else:
        assert set(res["metrics"]) == want == {"encode_fps", "setup_s"}
    for m in res["metrics"].values():
        assert m["value"] > 0


def _flip_byte(IntraEncoder):
    orig = IntraEncoder.encode

    def encode(self, frames):
        bits = bytearray(orig(self, frames))
        bits[len(bits) // 2] ^= 0x10
        return bytes(bits)
    return "encode", encode


def _drop_every_second(IntraEncoder):
    orig, calls = IntraEncoder.encode_frame, []

    def encode_frame(self, planes, poc):
        calls.append(poc)
        out = orig(self, planes, poc)
        return out if len(calls) % 2 else b""
    return "encode_frame", encode_frame


def _alf_off(IntraEncoder):
    """The control: the ALF search (and with it CC-ALF) left out."""
    orig = IntraEncoder.__init__

    def __init__(self, cfg, *args, **kw):
        cfg.alf = False
        orig(self, cfg, *args, **kw)
    return "__init__", __init__


def _stale_answer(IntraEncoder):
    """Every call answers with the previous call's stream and picture."""
    orig, last = IntraEncoder.encode, []

    def encode(self, frames):
        bits = orig(self, frames)
        last.append((bits, self.last_recon))
        bits, self.last_recon = last[-2] if len(last) > 1 else last[-1]
        return bits
    return "encode", encode


def _altered_sample(IntraEncoder):
    orig = IntraEncoder.encode

    def encode(self, frames):
        bits = orig(self, frames)
        self.last_recon[0][0, 0] ^= 1
        return bits
    return "encode", encode


FAULTS = {"control_alf_off": _alf_off, "flipped_byte": _flip_byte,
          "every_second_picture_dropped": _drop_every_second,
          "stale_answer": _stale_answer, "altered_sample": _altered_sample}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_control_and_faults_are_caught(man, two_frames, monkeypatch, fault):
    from vtm_tpu_torch.encoder.enc_lib import IntraEncoder

    attr, fn = FAULTS[fault](IntraEncoder)
    monkeypatch.setattr(IntraEncoder, attr, fn)
    res = harness.run_cell(man, CELL, SEED, 0.1, False, device="cpu")
    assert res["correct"] is False
    assert res["failed"] > 0
    assert res["checks"]["pictures_wrong"]["value"] > res["checks"]["pictures_wrong"]["limit"]


def test_seed_orders_the_frames_only(man, monkeypatch):
    """Two seeds encode the same frames with the same settings, each cycle
    every frame once, and the window ends with a whole cycle; set-up encodes
    the same frame's first CTU whatever the seed."""
    seen = {}

    def fake(EncoderConfig, IntraEncoder, enc_kw, frame, device):
        seen.setdefault("calls", []).append((int(frame[0].sum()), tuple(sorted(enc_kw.items()))))
        return b"", None

    monkeypatch.setattr(encode_frames, "_encode", fake)
    cfg = manifest.config(man, "ai-classD-qp37")
    frames = encode_frames.read_frames(cfg)
    sums = [int(f[0].sum()) for f in frames]
    runs = []
    for seed in (SEED, SEED + 1):
        seen.clear()
        harness.run_cell(man, CELL, seed, 0.05, False, device="cpu")
        calls = seen["calls"]
        n = cfg["encoder"]["ctu_size"]
        assert calls[0] == (int(frames[encode_frames.WARM_FRAME][0][:n, :n].sum()),
                            tuple(sorted(dict(cfg["encoder"], width=n, height=n).items())))
        assert {kw for _, kw in calls[1:]} == {tuple(sorted(cfg["encoder"].items()))}
        order = [sums.index(s) for s, _ in calls[1:]]
        assert len(order) >= 16 and len(order) % 8 == 0
        for c in range(0, len(order), 8):
            assert sorted(order[c:c + 8]) == list(range(8))
        runs.append(order[:16])
    assert runs[0] != runs[1]


def test_reference_made_by_the_recipe(man):
    """The recipe's record (made.log) names the settings of the
    configuration, and the stream MD5 and plane MD5s of every committed
    reference, each found equal to what the recipe wrote."""
    cfg = manifest.config(man, "ai-classD-qp37")
    with open(MADE_LOG) as f:
        lines = f.read().splitlines()
    enc = [json.loads(ln[len("encoder "):]) for ln in lines if ln.startswith("encoder ")]
    assert enc == [cfg["encoder"]]
    made = {int(ln.split()[1].rstrip(":")): ln for ln in lines if ln.startswith("frame ")}
    assert sorted(made) == [s["frame"] for s in cfg["streams"]]
    for s in cfg["streams"]:
        with open(os.path.join(manifest.HERE, s["bitstream"]), "rb") as f:
            bits = f.read()
        planes = vtm_reference.read_log(os.path.join(manifest.HERE, s["reference"]))[0]
        line = made[s["frame"]]
        assert f"{len(bits)} bytes, stream MD5 {hashlib.md5(bits).hexdigest()}, " in line
        assert f"planes {','.join(planes)}; committed .bit equal, .rec.log equal" in line
        assert "made.log" in s["made_by"]


def test_frames_scaled_to_the_bit_depth_inside(man):
    cfg = manifest.config(man, "ai-classD-qp37")
    frames = encode_frames.read_frames(cfg)
    assert len(frames) == len(cfg["streams"]) == 8
    y, cb, cr = frames[0]
    assert y.shape == (240, 416) and cb.shape == cr.shape == (120, 208)
    assert all(int(p.max()) < 1 << 10 and not (p % 4).any() for p in frames[0])


def test_rmd_work_is_the_programs_count(man):
    """The yardstick's frozen copy gives the classes, positions, columns and
    SATD tiles that the program's FrameRMD and its kernels use."""
    import numpy as np

    from vtm_tpu_torch.encoder import rmd as RMD
    from vtm_tpu_torch.encoder.enc_lib import EncoderConfig
    from vtm_tpu_torch.ops import rdcost as RC

    enc = manifest.config(man, "ai-classD-qp37")["encoder"]
    cfg = EncoderConfig(**enc)
    assert rmd_work.classes(enc) == RMD.intra_class_list(cfg)
    assert rmd_work.PAD_R == RMD.PAD_R and rmd_work.N_ANG == RMD.N_ANG
    ops = 0
    for w, h in RMD.intra_class_list(cfg):
        sx, sy = RMD._class_strides(w, h)
        p = len(np.arange(0, enc["width"] - w + 1, sx)) * len(np.arange(0, enc["height"] - h + 1, sy))
        assert rmd_work.positions(w, h, enc["width"], enc["height"]) == p
        n_mip = RMD._mip_weights(w, h).shape[0]
        assert rmd_work.columns(w, h, True) == RMD.N_ANG + 2 * n_mip
        kind = RC.satd_kind(h, w)
        assert rmd_work.tile(h, w) == (None if kind == RC.SAD else RC.KINDS[kind])
        ops += p * (RMD.N_ANG + 2 * n_mip) * h * w * (4 + rmd_work.satd_ops(h, w))
    assert rmd_work.frame_work(enc)[1] == ops
