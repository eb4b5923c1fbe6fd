"""Segment (GOP) parallel encoding: the codec's multi-host scaling axis
(the reference mechanism is an offline segment encode stitched by Parcat,
App/Parcat/readme.md).

Frames are split at IRAP boundaries into independent segments; each
segment encodes in its own worker process (on a production deployment:
one host per segment), and the bitstreams are stitched with
vtm_tpu_torch.apps.parcat into one stream that is bit-identical to the
sequential intra-period encode.  parcat keeps only the first segment's
APS, as the reference's does, so segments are to be encoded with ALF off
(with ALF, the later segments decode with the first segment's filters).

Every encoder runs on the device the caller names (`device`, CUDA by
default; a CUDA request on a machine without it raises before any worker
starts).  Kernel launch counts are per process (vtm_tpu_torch.kernels), so
each worker returns its launches with its stream and the parent adds them
to its own: after `encode_parallel`, `kernels.launch_counts()` counts the
launches made on its behalf.
"""

from __future__ import annotations

import multiprocessing
import os
import tempfile
from concurrent.futures import ProcessPoolExecutor


def _encode_segment(args):
    (mode, cfg_kwargs, frames, kw, device) = args
    from vtm_tpu_torch.encoder import enc_lib as E

    cfg = E.EncoderConfig(**cfg_kwargs)
    enc_cls = {
        "intra": E.IntraEncoder,
        "ldp": E.InterEncoder,
        "ldb": E.LowDelayBEncoder,
        "ra": E.RandomAccessEncoder,
    }[mode]
    enc = enc_cls(cfg, device=device, **kw)
    return enc.encode(frames)


def _encode_segment_counted(args):
    """_encode_segment in a worker process: (the stream, the kernel
    launches of this segment's encode)."""
    from vtm_tpu_torch import kernels as KN

    KN.reset_launch_counts()
    bits = _encode_segment(args)
    return bits, KN.launch_counts()


def encode_parallel(frames, cfg_kwargs: dict, mode: str = "ldp",
                    segment_len: int = 8, workers: int | None = None,
                    enc_kwargs: dict | None = None,
                    device: str = "cuda") -> bytes:
    """Encode `frames` as ceil(N/segment_len) independent segments in
    parallel worker processes on `device` and parcat-stitch the results."""
    from vtm_tpu_torch import kernels as KN
    from vtm_tpu_torch import native
    from vtm_tpu_torch.apps.parcat import parcat
    from vtm_tpu_torch.device import resolve_device

    kw = enc_kwargs or {}
    if "device" in kw:
        raise ValueError("enc_kwargs names 'device'; pass it as encode_parallel's "
                         "device")
    dev = resolve_device(device)
    segments = [frames[i : i + segment_len]
                for i in range(0, len(frames), segment_len)]
    jobs = [(mode, cfg_kwargs, seg, kw, str(dev)) for seg in segments]
    if workers is None:
        workers = min(len(segments), os.cpu_count() or 1)
    if workers > 1 and len(segments) > 1:
        # build the kernel library and the native modules here, once, so
        # that the workers load finished libraries
        for load in (native.load_cabac, native.load_tcq, native.load_depquant):
            load()
        if dev.type == "cuda":
            KN.library()
        # spawn, not fork: a forked child cannot use a CUDA context that
        # its parent opened; spawn gives each worker a clean runtime
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(max_workers=workers, mp_context=ctx) as pool:
            results = list(pool.map(_encode_segment_counted, jobs))
        streams = [bits for bits, _ in results]
        for _, launches in results:
            KN.add_launch_counts(launches)
    else:
        streams = [_encode_segment(j) for j in jobs]
    with tempfile.TemporaryDirectory() as td:
        paths = []
        for i, s in enumerate(streams):
            p = os.path.join(td, f"seg{i}.bit")
            with open(p, "wb") as f:
                f.write(s)
            paths.append(p)
        return parcat(paths)
