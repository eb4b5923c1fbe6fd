"""Closed-loop decode: whole streams of the configuration, back to back,
each through a fresh `vtm_tpu_torch.decoder.declib.Decoder`, as a player
opening a stream does.

Set-up decodes every stream of the configuration once (the kernels, their
shapes and the native parsers warm).  The window then decodes streams in
the order the traffic generator draws from the seed, and closes at the
first stream boundary after `--seconds`; `decode_fps` is every picture
decoded over the whole window.  Once it has closed, every picture of every
stream decoded in it is compared with VTM 9.3's (vtm_reference.py).

With `--trace 1` the harness wraps spans around `Decoder._decode_slice`
(slice decode), `Decoder.finish_picture` (picture finish) and each stream,
times each picture as the decoder completes it, records the in-loop
chain's shapes and stage flags at `ops/filter_chain.py:chain_body` and
opens a profiler range ("vvcbench.chain") around it, and profiles the
window.
"""

from __future__ import annotations

import contextlib
import inspect
import os
import time

from vvcbench import card, devtrace, manifest, traffic, vtm_reference
from vvcbench.spans import Spans, wrap


class Hooks:
    """The trace run's instrumentation, wrapped around the program's calls."""

    def __init__(self):
        from vtm_tpu_torch.decoder.declib import Decoder
        from vtm_tpu_torch.ops import filter_chain as FC

        self.spans = Spans()
        self.picture_s: list[float] = []
        self.chain_calls: list = []
        self._done: list[float] = []
        sp = self.spans

        def slice_(orig):
            def _decode_slice(dec, nal):
                with sp.span("slice"):
                    return orig(dec, nal)
            return _decode_slice

        def finish(orig):
            def finish_picture(dec):
                n = len(dec.output)
                with sp.span("finish"):
                    orig(dec)
                if len(dec.output) > n:
                    self._done.append(time.perf_counter())
            return finish_picture

        def chain(orig):
            from torch.profiler import record_function

            sig = inspect.signature(orig)

            def chain_body(*args, **kw):
                a = sig.bind(*args, **kw).arguments
                shapes = [tuple(a[k].shape) for k in ("y", "cb", "cr")]
                self.chain_calls.append((shapes, int(a["bd"]), tuple(a["fl"])))
                # a profiler range, not a span: finish keeps the chain's
                # host time in its own
                with record_function("vvcbench.chain"):
                    return orig(*args, **kw)
            return chain_body

        self._undo = [wrap(Decoder, "_decode_slice", slice_),
                      wrap(Decoder, "finish_picture", finish),
                      wrap(FC, "chain_body", chain)]

    def reset(self) -> None:
        self.spans.reset()
        self.picture_s.clear()
        self.chain_calls.clear()

    def stream(self, decode):
        """decode() under a "stream" span; each picture's time appended:
        from the stream's start, or the last picture's completion, to its
        own (the last picture's to the stream's end, flush included)."""
        self._done = []
        t0 = time.perf_counter()
        with self.spans.span("stream"):
            out = decode()
        marks = [t0] + self._done[:-1] + [time.perf_counter()]
        self.picture_s.extend(b - a for a, b in zip(marks, marks[1:]))
        return out

    def remove(self) -> None:
        for undo in reversed(self._undo):
            undo()


def _decode(Decoder, bits: bytes, device: str) -> list:
    """[(poc, host planes)] of one stream; the decoder is dropped."""
    return [(p.poc, p.planes) for p in Decoder(device=device).decode_stream(bits)]


def _sync(device: str) -> None:
    import torch

    if device != "cpu":
        torch.cuda.synchronize()


def run(r) -> None:
    import torch
    from vtm_tpu_torch.decoder.declib import Decoder

    streams = []
    for s in r.config["streams"]:
        with open(os.path.join(manifest.HERE, s["bitstream"]), "rb") as f:
            bits = f.read()
        streams.append((bits, vtm_reference.read_log(os.path.join(manifest.HERE, s["reference"]))))
    order = traffic.input_order(r.seed, len(streams))
    hooks = Hooks() if r.traced else None
    decode = ((lambda b: hooks.stream(lambda: _decode(Decoder, b, r.device)))
              if hooks else (lambda b: _decode(Decoder, b, r.device)))
    done = []
    try:
        for bits, _ in streams:
            decode(bits)
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
                done.append((i, decode(streams[i][0])))
                if time.perf_counter() - t0 >= r.seconds:
                    break
            _sync(r.device)
            r.window_s = time.perf_counter() - t0
        if hooks:
            r.trace = devtrace.reduce(prof)
            r.picture_s = list(hooks.picture_s)
            r.span_self_s = dict(hooks.spans.self_s)
            r.chain_calls = list(hooks.chain_calls)
    finally:
        if hooks:
            hooks.remove()
    r.pictures = sum(len(got) for _, got in done)
    if r.device != "cpu":
        r.memory_peak_bytes = torch.cuda.max_memory_allocated()
    bit_depth = r.config["InternalBitDepth"]
    r.attempted = sum(len(streams[i][1]) for i, _ in done)
    r.failed = sum(vtm_reference.wrong_pictures(streams[i][1], got, bit_depth)
                   for i, got in done)
    r.checks = {"pictures_wrong": {"value": r.failed, "limit": 0}}
