"""Closed-loop all-intra encode: one frame of the configuration a request,
each encoded as a one-picture stream by a fresh
`vtm_tpu_torch.encoder.enc_lib.IntraEncoder(EncoderConfig(**encoder))`, as
a chunked transcoder running the all-intra condition does.

Set-up reads the configuration's source frames, scales them to the bit
depth inside, and encodes the first CTU of one frame as a picture of its
own, untimed: every RMD class's kernel, the native CABAC and quantiser
libraries and the encoder's host tables are built and loaded before the
window.  The window then encodes frames in cycles, each cycle every frame
once in the order the traffic generator draws from the seed, and closes at
the first cycle boundary after `--seconds`, so that every run encodes the
same frames however the seed orders them; `encode_fps` is every picture
encoded over the whole window.  Once it has closed, every picture encoded
in it is compared with vtm_tpu's (encode_reference.py): its stream byte for
byte, and the MD5 of each plane of the encoder's reconstruction.

With `--trace 1` the harness wraps spans around each encode call
("picture"), FrameRMD's construction, `prefetch_rows` and `_fetch`, the one
point where its tables are read back from the device ("rmd"),
`ops/deblock.py:deblock_picture` ("deblock") and
`IntraEncoder._sao_and_rewrite` (the SAO, ALF and CC-ALF searches and
filters and the slice's final write: "sao_alf"), and profiles the window.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np

from vvcbench import card, devtrace, encode_reference, manifest, traffic, vtm_reference
from vvcbench.spans import Spans, wrap

WARM_FRAME = 0  # the frame whose first CTU set-up encodes, whatever the seed


class Hooks:
    """The trace run's instrumentation, wrapped around the program's calls."""

    def __init__(self):
        from vtm_tpu_torch.encoder import rmd as RMD
        from vtm_tpu_torch.encoder.enc_lib import IntraEncoder
        from vtm_tpu_torch.ops import deblock as DB

        self.spans = Spans()
        self.picture_s: list[float] = []
        sp = self.spans

        def spanned(name):
            """A wrapper that opens span `name` around the call."""
            def make(orig):
                def call(*args, **kw):
                    with sp.span(name):
                        return orig(*args, **kw)
                return call
            return make

        F = RMD.FrameRMD
        fetch = F.__dict__["_fetch"]  # a staticmethod: wrapped and put back as one
        F._fetch = staticmethod(spanned("rmd")(fetch.__func__))
        self._undo = [
            lambda: setattr(F, "_fetch", fetch),
            wrap(F, "__init__", spanned("rmd")),
            wrap(F, "prefetch_rows", spanned("rmd")),
            wrap(DB, "deblock_picture", spanned("deblock")),
            wrap(IntraEncoder, "_sao_and_rewrite", spanned("sao_alf")),
        ]

    def reset(self) -> None:
        self.spans.reset()
        self.picture_s.clear()

    def picture(self, encode):
        """encode() under a "picture" span, its time appended."""
        t0 = time.perf_counter()
        with self.spans.span("picture"):
            out = encode()
        self.picture_s.append(time.perf_counter() - t0)
        return out

    def remove(self) -> None:
        for undo in reversed(self._undo):
            undo()


def read_frames(cfg: dict) -> list[list[np.ndarray]]:
    """Every frame of the configuration's 4:2:0 source, as int32 planes
    scaled from the input's bit depth to the one inside."""
    w, h = cfg["SourceWidth"], cfg["SourceHeight"]
    if cfg["InputChromaFormat"] != 420 or cfg["InputBitDepth"] != 8:
        raise ValueError("encode_frames reads 8-bit 4:2:0 sources")
    raw = np.fromfile(os.path.join(manifest.HERE, cfg["source_yuv"]), np.uint8)
    size = w * h * 3 // 2
    shift = cfg["InternalBitDepth"] - cfg["InputBitDepth"]
    frames = []
    for k in range(len(raw) // size):
        f = raw[k * size:(k + 1) * size].astype(np.int32)
        c = w * h // 4
        planes = (f[:w * h].reshape(h, w), f[w * h:w * h + c].reshape(h // 2, w // 2),
                  f[w * h + c:].reshape(h // 2, w // 2))
        frames.append([p << shift for p in planes])
    return frames


def _encode(EncoderConfig, IntraEncoder, enc_kw: dict, frame, device: str):
    """(stream, reconstructed planes) of one frame; the encoder is dropped."""
    enc = IntraEncoder(EncoderConfig(**enc_kw), device=device)
    bits = enc.encode([frame])
    return bits, getattr(enc, "last_recon", None)


def _warm_up(EncoderConfig, IntraEncoder, enc_kw: dict, frame, device: str) -> None:
    """Encode the frame's first CTU as a picture of its own: the same tools,
    classes and libraries as a whole picture, at a small part of its time."""
    n = enc_kw["ctu_size"]
    crop = [np.ascontiguousarray(p[:n >> s, :n >> s]) for p, s in zip(frame, (0, 1, 1))]  # 4:2:0
    _encode(EncoderConfig, IntraEncoder, dict(enc_kw, width=n, height=n), crop, device)


def _sync(device: str) -> None:
    import torch

    if device != "cpu":
        torch.cuda.synchronize()


def run(r) -> None:
    import torch
    from vtm_tpu_torch.encoder.enc_lib import EncoderConfig, IntraEncoder

    cfg = r.config
    frames = read_frames(cfg)
    refs = []
    for s in cfg["streams"]:
        with open(os.path.join(manifest.HERE, s["bitstream"]), "rb") as f:
            bits = f.read()
        log = vtm_reference.read_log(os.path.join(manifest.HERE, s["reference"]))
        refs.append((s["frame"], bits, log[0]))
    order = traffic.input_order(r.seed, len(refs))
    enc_kw = cfg["encoder"]
    hooks = Hooks() if r.traced else None

    def encode(k):
        call = lambda: _encode(EncoderConfig, IntraEncoder, enc_kw, frames[k], r.device)  # noqa: E731
        return hooks.picture(call) if hooks else call()

    done = []
    try:
        _warm_up(EncoderConfig, IntraEncoder, enc_kw, frames[WARM_FRAME], r.device)
        _sync(r.device)
        with contextlib.ExitStack() as stack:
            if hooks:
                prof = stack.enter_context(devtrace.profiled(r.device))
                hooks.reset()
                stack.enter_context(torch.profiler.record_function(devtrace.WINDOW))
            r.setup_s = card.since_process_start()
            t0 = time.perf_counter()
            while True:
                i = next(order)
                done.append((i, encode(refs[i][0])))
                if len(done) % len(refs) == 0 and time.perf_counter() - t0 >= r.seconds:
                    break
            _sync(r.device)
            r.window_s = time.perf_counter() - t0
        if hooks:
            r.trace = devtrace.reduce(prof)
            r.picture_s = list(hooks.picture_s)
            r.span_self_s = dict(hooks.spans.self_s)
    finally:
        if hooks:
            hooks.remove()
    r.pictures = len(done)
    if r.device != "cpu":
        r.memory_peak_bytes = torch.cuda.max_memory_allocated()
    bit_depth = cfg["InternalBitDepth"]
    r.attempted = len(done)
    r.failed = sum(encode_reference.wrong_picture(refs[i][1], refs[i][2], bits, recon, bit_depth)
                   for i, (bits, recon) in done)
    r.checks = {"pictures_wrong": {"value": r.failed, "limit": 0}}
