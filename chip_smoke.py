#!/usr/bin/env python3
"""Smoke run of vtm_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card, nvcc and
PyTorch built for CUDA (no jax needed).  Phases, each fatal on failure:

1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
   no CUDA means exit 1 with no result;
2. build the CUDA kernels of vtm_tpu_torch/csrc from the checkout (nvcc,
   sm_90a, one process per source, in parallel);
3. each kernel against its plain torch version, exactly:
   - the filter kernels on the real chain inputs of POC 0 of
     testdata/ai_full_hd1080_qp37.bit (1920x1080 4:2:0 8-bit, LMCS +
     deblock + SAO + ALF + CC-ALF), and on a numpy-seeded 10-bit 4:4:4
     case;
   - the MC, DMVR-search, FIR and BDOF kernels on the inputs of every call
     of the port's own CUDA decode of testdata/ra_full_bq416_qp37.bit
     (416x240 RA, every inter tool on), and on numpy-seeded batches the
     size of a 1080p 4:2:0 picture;
   kernel and plain times from CUDA events, on the 1080p inputs;
   - the SATD kernel on numpy-seeded differences of every tiling (8- and
     10-bit extremes), 1920x1080 samples per call;
   - the three RMD kernels on every block-size class of a 1920x1080 picture
     mirror-tiled from testdata/bq416_416x240_420_8.yuv (MIP on, 888,628
     positions), and on a numpy-seeded 10-bit 256x192 picture;
   - the two inverse transforms (int32 MACs; int8 tensor cores) on batches
     the size of a 1920x1080 plane, every block size and kind pair, 8- and
     10-bit, each against the plain version and the two against each
     other; the luma deblocking delta and the extended-plane SAO on the
     eight 240-column shards (with real halos) of the 1080p picture; the
     recon/SSE epilogue on two 1080p planes of 32x32 blocks;
   each row of the kernel JSON carries its bound: the larger of the bytes
   its timed calls must move (inputs read once, outputs written once) over
   the card's 3.35 TB/s and their operations over the peak rate of their
   type (int32: 132 SMs x 64 lanes x 1.98 GHz; int8 tensor cores: 1,979
   T/s);
4. the decode main path through vtm_tpu_torch.decoder.declib.Decoder(
   device="cuda"): the 1080p all-intra stream, three small all-intra streams
   (10-bit, 4:2:2, CC-ALF) and three inter streams (the flagship RA stream,
   LD-B with every tool, IBC), every picture hash checked;
5. the encode main path through vtm_tpu_torch.encoder.enc_lib.IntraEncoder(
   device="cuda"): three 208x120 encodes (CC-ALF, MIP and SAO engaged),
   byte-identical to the same encodes with device="cpu", and one 1920x1080
   picture at QP 37 (bench.py's north-star configuration), each stream
   decoded hash-exact by the port's decoder;
6. the multi-device main path on lanes that share the one card
   (vtm_tpu_torch.parallel): dryrun_multichip on both pictures of the 1080p
   stream at gop 2 x tile 2 and at tile 8 (240 columns a lane), and on
   ra_full_small208_qp32 at n = 2 and 8 (the reference's own case); the MC
   job axis split over 4 lanes on a 1080p-sized seeded batch and on a slice
   batch of the flagship RA stream; sharded_recon_step at F = 2, T = 2040,
   N = 32 on 4 lanes; every lane equal to its picture's single-lane result
   (MC and recon: to the plain version's), and each sharded stage run 7
   times, its host seconds (median, min, max) beside its one-lane run's;
   the decodes that capture its inputs run before its counts are zeroed;
   launch counts, zeroed before each main path and read after it, prove
   that the three paths ran through every kernel (two excepted, checked and
   timed in phase 3 only: the standalone SATD entry point, whose code runs
   inside the RMD kernels, and the int8 transform, which the reference
   calls from its tests alone); the encodes' own
   counts, without the decodes that check their streams, prove that the
   encoder's RMD, deblocking, SAO and ALF ran through the kernels;
7. one JSON line of per-kernel results, then the device line, last.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
TESTDATA = os.path.join(ROOT, "testdata")
HD_STREAM = "ai_full_hd1080_qp37"
SMALL_STREAMS = ("ai10_small208_qp32", "ai422_small208_qp32",
                 "ai_ccalf_cc208_qp32")
RA_STREAM = "ra_full_bq416_qp37"
INTER_STREAMS = (RA_STREAM, "ldb_full_small208_qp32", "sc_ibc_ldb_qp32")
INTER_KERNELS = ("vtm_mc_tiles", "vtm_dmvr_search", "vtm_fir_blocks",
                 "vtm_bdof_blend")
# C entry point -> (source, TPU kernel it replaces)
KERNEL_INFO = {
    "vtm_deblock_luma_ver": ("vtm_tpu_torch/csrc/deblock.cu",
                             "vtm_tpu/ops/deblock_kernel.py:292"),
    "vtm_deblock_luma_ver_delta": ("vtm_tpu_torch/csrc/deblock.cu",
                                   "vtm_tpu/ops/deblock_kernel.py:68"),
    "vtm_deblock_chroma_ver": ("vtm_tpu_torch/csrc/deblock.cu",
                               "vtm_tpu/ops/deblock_kernel.py:350"),
    "vtm_sao_apply": ("vtm_tpu_torch/csrc/sao.cu",
                      "vtm_tpu/ops/sao_kernel.py:20"),
    "vtm_sao_apply_ext": ("vtm_tpu_torch/csrc/sao.cu",
                          "vtm_tpu/ops/sao_kernel.py:28"),
    "vtm_alf_classify": ("vtm_tpu_torch/csrc/alf.cu",
                         "vtm_tpu/ops/alf_kernel.py:111"),
    "vtm_alf_filter": ("vtm_tpu_torch/csrc/alf.cu",
                       "vtm_tpu/ops/alf_kernel.py:194"),
    "vtm_ccalf_filter": ("vtm_tpu_torch/csrc/alf.cu",
                         "vtm_tpu/ops/alf_kernel.py:290"),
    "vtm_mc_tiles": ("vtm_tpu_torch/csrc/mc.cu",
                     "vtm_tpu/ops/mc_kernel.py:36"),
    "vtm_dmvr_search": ("vtm_tpu_torch/csrc/refine.cu",
                        "vtm_tpu/ops/refine_kernel.py:70"),
    "vtm_fir_blocks": ("vtm_tpu_torch/csrc/refine.cu",
                       "vtm_tpu/ops/refine_kernel.py:145"),
    "vtm_bdof_blend": ("vtm_tpu_torch/csrc/refine.cu",
                       "vtm_tpu/ops/refine_kernel.py:182"),
    "vtm_satd_batch": ("vtm_tpu_torch/csrc/rdcost.cu",
                       "vtm_tpu/ops/rdcost.py:127"),
    "vtm_rmd_angular": ("vtm_tpu_torch/csrc/rmd.cu",
                        "vtm_tpu/encoder/rmd_tpu.py:516"),
    "vtm_rmd_mip": ("vtm_tpu_torch/csrc/rmd.cu",
                    "vtm_tpu/encoder/rmd_tpu.py:374"),
    "vtm_rmd_reduce": ("vtm_tpu_torch/csrc/rmd.cu",
                       "vtm_tpu/encoder/rmd_tpu.py:579"),
    "vtm_inv_transform": ("vtm_tpu_torch/csrc/transform.cu",
                          "vtm_tpu/ops/transform.py:131"),
    "vtm_inv_transform_s8": ("vtm_tpu_torch/csrc/transform.cu",
                             "vtm_tpu/ops/transform.py:152"),
    "vtm_recon_sse": ("vtm_tpu_torch/csrc/transform.cu",
                      "vtm_tpu/parallel/mesh.py:58"),
}
# peak rates of one H100 SXM at 700 W: memory, int32 lanes, int8 tensor cores
BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
INT8_TC_OPS_PER_S = 1979e12
# kernels of the multi-device main path (phase 6)
MESH_KERNELS = ("vtm_inv_transform", "vtm_recon_sse",
                "vtm_deblock_luma_ver_delta", "vtm_sao_apply_ext",
                "vtm_alf_classify", "vtm_alf_filter", "vtm_mc_tiles",
                "vtm_deblock_luma_ver", "vtm_deblock_chroma_ver", "vtm_sao_apply")
# runs of each sharded stage whose host seconds are compared (median)
REPEATS = 7
TRANSFORM_KINDS = ((0, 0), (2, 1), (1, 2), (2, 2), (1, 1))
# kernels checked and timed in phase 3 that no main path launches by name
NOT_ON_MAIN_PATH = {"vtm_satd_batch": "its code runs fused inside vtm_rmd_angular "
                                      "and vtm_rmd_mip (csrc/satd.cuh)",
                    "vtm_inv_transform_s8": "the reference has no caller of its twin "
                                            "(vtm_tpu/ops/transform.py:152) outside "
                                            "its tests; sharded_recon_step uses the "
                                            "int32 transform, as the reference does"}
SATD_SHAPES = ((4, 4), (8, 8), (16, 16), (8, 16), (16, 8), (4, 8), (8, 4),
               (4, 16), (16, 4), (32, 32), (64, 64), (2, 2), (3, 5))
# the encodes of phase 5: CC-ALF engages in the first, MIP in the second,
# SAO in the third (the SAO search turns SAO off in every CTU of the first)
ENC_CASES = (("cc208_208x120_420_8", dict(qp=37, sao=True, alf=True, ccalf=True)),
             ("small208_208x120_420_8", dict(qp=32, mip=True)),
             ("screen208_208x120_420_8", dict(qp=37, sao=True)))
ENC_KERNELS = ("vtm_rmd_angular", "vtm_rmd_mip", "vtm_rmd_reduce",
               "vtm_deblock_luma_ver", "vtm_deblock_chroma_ver", "vtm_sao_apply",
               "vtm_alf_classify", "vtm_alf_filter")
# decode kernels the encoder does not launch: only the decodes of its streams
NOT_IN_ENCODER = {"vtm_ccalf_filter": "the encoder applies CC-ALF on the host "
                                      "(vtm_tpu.encoder.alf_search.derive_ccalf, "
                                      "taken unchanged)"}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters: int = 10) -> float:
    """Mean device time of fn() in ms (CUDA events, after up to two
    warm-up calls)."""
    for _ in range(min(2, iters)):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_err(torch, a, b) -> int:
    """Largest |a - b| over matching tensor trees; raises on a shape change."""
    if isinstance(a, (tuple, list)):
        return max(max_err(torch, x, y) for x, y in zip(a, b, strict=True))
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def read_stream(name: str) -> bytes:
    with open(os.path.join(TESTDATA, f"{name}.bit"), "rb") as f:
        return f.read()


def nbytes(*trees) -> int:
    """Bytes of the distinct tensors in nested tuples / lists (each counted
    once, however often it appears)."""
    seen, total = set(), 0

    def walk(x):
        nonlocal total
        if isinstance(x, (tuple, list)):
            for y in x:
                walk(y)
        elif hasattr(x, "data_ptr") and x.data_ptr() not in seen:
            seen.add(x.data_ptr())
            total += x.numel() * x.element_size()

    walk(trees)
    return total


class KernelCheck:
    """Per-kernel results: largest deviation from the plain version, the two
    times, and the bytes and operations of the work, summed over the cases
    that time the kernel."""

    def __init__(self, torch):
        self.torch = torch
        self.rows = {k: dict(max_abs_err=0, ms=0.0, plain_ms=0.0, bytes=0,
                             ops=0.0, peak=INT32_OPS_PER_S)
                     for k in KERNEL_INFO}

    def compare(self, kernel: str, label: str, cuda_fn, plain_fn,
                timed: bool = False, iters: int = 10, ins=(), ops: float = 0,
                peak: float = INT32_OPS_PER_S, quiet: bool = False):
        """Kernel against plain version; with `timed`, both timed, and the
        bound counted: the bytes of `ins` and of the result, and `ops`
        operations at `peak` per second.  `quiet` prints nothing unless the
        two disagree."""
        torch = self.torch
        got = cuda_fn()
        want = plain_fn()
        torch.cuda.synchronize()
        err = max_err(torch, got, want)
        row = self.rows[kernel]
        row["max_abs_err"] = max(row["max_abs_err"], err)
        msg = f"{kernel} [{label}]: max |kernel - plain| = {err}"
        if timed:
            ms = cuda_ms(torch, cuda_fn, iters)
            pms = cuda_ms(torch, plain_fn, iters)
            row["ms"] += ms
            row["plain_ms"] += pms
            row["bytes"] += nbytes(ins, got)
            row["ops"] += ops
            row["peak"] = peak
            msg += f", kernel {ms:.4f} ms, plain {pms:.4f} ms"
        if err or not quiet:
            print(msg, flush=True)
        if err:
            raise AssertionError(f"{kernel} [{label}] disagrees with its plain version")
        return got

    def bound(self, kernel: str) -> tuple[float, str]:
        """(least ms the card could take for the timed work, what bounds it)."""
        row = self.rows[kernel]
        t_bytes = row["bytes"] / BYTES_PER_S * 1e3
        t_ops = row["ops"] / row["peak"] * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_kernels(torch, chk: KernelCheck, y, cb, cr, lut, dbv, dbh, sao, alf,
                  bd, sx, sy, fl, label: str, timed: bool):
    """Every kernel against its plain version on one picture's chain
    inputs, stage by stage (each stage's input is the previous stage's
    output)."""
    import numpy as np

    from vtm_tpu_torch.ops import alf_kernel as AK
    from vtm_tpu_torch.ops import deblock_kernel as DK
    from vtm_tpu_torch.ops import edge_pad
    from vtm_tpu_torch.ops import sao_kernel as SK

    (f_lmcs, dvl, dvcb, dvcr, dhl, dhcb, dhcr,
     s0, s1, s2, a_l, a_cb, a_cr, a_cc1, a_cc2) = fl
    if f_lmcs:
        y = lut[y.long()]
    for hor, maps, (hl, hcb, hcr) in ((False, dbv, (dvl, dvcb, dvcr)),
                                      (True, dbh, (dhl, dhcb, dhcr))):
        tag = f"{label} {'HOR' if hor else 'VER'}"
        kw = dict(bit_depth=bd, hor=hor, sx=sx, sy=sy)
        if hl:
            lk = dict(kw, has_l=True, has_cb=False, has_cr=False)
            y = chk.compare(
                "vtm_deblock_luma_ver", tag,
                lambda: DK.deblock_dir_cuda(y, cb, cr, *maps, **lk)[0],
                lambda: DK.deblock_dir_plain(y, cb, cr, *maps, **lk)[0], timed,
                ins=(y, maps[0:7]), ops=10 * y.numel())
        if hcb or hcr:
            ck = dict(kw, has_l=False, has_cb=hcb, has_cr=hcr)
            _, cb, cr = chk.compare(
                "vtm_deblock_chroma_ver", tag,
                lambda: DK.deblock_dir_cuda(y, cb, cr, *maps, **ck),
                lambda: DK.deblock_dir_plain(y, cb, cr, *maps, **ck), timed,
                ins=(cb, cr, maps[7:17]), ops=10 * (cb.numel() + cr.numel()))
    planes = [y, cb, cr]
    for comp, on in enumerate((s0, s1, s2)):
        if on:
            p, m = planes[comp], sao[comp]
            planes[comp] = chk.compare(
                "vtm_sao_apply", f"{label} comp {comp}",
                lambda: SK.sao_apply_cuda(p, *m, bit_depth=bd),
                lambda: SK.sao_apply_plain(p, *m, bit_depth=bd), timed,
                ins=(p, m), ops=8 * p.numel())
    y, cb, cr = planes
    y_pad = edge_pad(y, AK.PAD, AK.PAD)
    (cperm, lperm, ctu_of, l_orows, l_near, y_i, yd_i, yu_i, yu2_i, df, dl,
     mult, cb_coef, cb_clip, cr_coef, cr_clip, c_orows, c_near, cc1, cc2,
     cc_orows, cc_skip) = alf
    if a_l:
        rows = (y_i, yd_i, yu_i, yu2_i, df, dl, mult)
        cls, tr = chk.compare(
            "vtm_alf_classify", label,
            lambda: AK.classify_picture_cuda(y_pad, *rows, bit_depth=bd),
            lambda: AK.classify_picture_plain(y_pad, *rows, bit_depth=bd), timed,
            ins=(y_pad, rows), ops=12 * y.numel())
        gather = (ctu_of.long(), cls.long(), tr.long())
        coef, clip = cperm[gather], lperm[gather]
        chk.compare(
            "vtm_alf_filter", f"{label} luma",
            lambda: AK.alf_filter_cuda(y_pad, coef, clip, l_orows, l_near,
                                       taps=AK.LUMA_TAPS, bit_depth=bd),
            lambda: AK.alf_filter_plain(y_pad, coef, clip, l_orows, l_near,
                                        taps=AK.LUMA_TAPS, bit_depth=bd), timed,
            ins=(y_pad, coef, clip, l_orows, l_near), ops=48 * y.numel())
    for on, c, co, cl in ((a_cb, cb, cb_coef, cb_clip), (a_cr, cr, cr_coef, cr_clip)):
        if on:
            c_pad = edge_pad(c, AK.PAD, AK.PAD)
            chk.compare(
                "vtm_alf_filter", f"{label} chroma",
                lambda: AK.alf_filter_cuda(c_pad, co, cl, c_orows, c_near,
                                           taps=AK.CHROMA_TAPS, bit_depth=bd),
                lambda: AK.alf_filter_plain(c_pad, co, cl, c_orows, c_near,
                                            taps=AK.CHROMA_TAPS, bit_depth=bd),
                timed, ins=(c_pad, co, cl, c_orows, c_near), ops=24 * c.numel())
    cc_cases = [(c, cc, label) for on, c, cc in ((a_cc1, cb, cc1), (a_cc2, cr, cc2))
                if on]
    if timed and not cc_cases:
        # no CC-ALF CTB in this picture: time the kernel at its shapes with
        # seeded coefficients
        rng = np.random.default_rng(3)
        cc = rng.integers(-32, 33, size=tuple(cc1.shape), dtype=np.int32)
        cc_cases = [(cb, torch.from_numpy(cc).to(cb.device),
                     f"{label}, seeded coefficients")]
    kw = dict(scale_x=sx, scale_y=sy, bit_depth=bd)
    for c, cc, tag in cc_cases:
        chk.compare(
            "vtm_ccalf_filter", tag,
            lambda: AK.ccalf_filter_cuda(y_pad, c, cc, cc_orows, cc_skip, **kw),
            lambda: AK.ccalf_filter_plain(y_pad, c, cc, cc_orows, cc_skip, **kw),
            timed, ins=(y_pad, c, cc, cc_orows, cc_skip), ops=14 * c.numel())
    flags = dict(has_l=a_l, has_cb=a_cb, has_cr=a_cr, has_cc1=a_cc1, has_cc2=a_cc2)
    got = AK.alf_all(y_pad, cb, cr, *alf, bit_depth=bd, sx=sx, sy=sy, **flags)
    want = AK.alf_all_plain(y_pad, cb, cr, *alf, bit_depth=bd, sx=sx, sy=sy, **flags)
    err = max_err(torch, got, want)
    print(f"alf_all [{label}]: max |kernel - plain| = {err}", flush=True)
    if err:
        raise AssertionError(f"alf_all [{label}] disagrees with its plain version")


def random_case(torch, chk: KernelCheck, dev, seed: int = 7):
    """A numpy-seeded 10-bit 4:4:4 picture through every kernel."""
    import numpy as np

    from vtm_tpu_torch import testing as T
    from vtm_tpu_torch.ops.filter_chain import to_device

    rng = np.random.default_rng(seed)
    h, w, bd, ctu = 192, 256, 10, 64
    y, cb, cr = (to_device(p, dev) for p in T.planes(rng, h, w, "444", bd))
    # a monotone LMCS-like inverse map keeps the planes' edges filterable
    lut = to_device(np.minimum(np.arange(1 << bd) * 15 // 16 + 24, (1 << bd) - 1), dev)
    dbv = tuple(to_device(m, dev) for m in T.deblock_maps(rng, h, w, bd, False))
    dbh = tuple(to_device(m, dev) for m in T.deblock_maps(rng, h, w, bd, True))
    n_ctu = (h // ctu) * (w // ctu)
    sao = [tuple(to_device(m, dev) for m in T.sao_maps(rng, h, w, n_ctu, bd))
           for _ in range(3)]
    alf = tuple(to_device(a, dev) for a in T.alf_tables(rng, h, w, "444", bd, ctu))
    check_kernels(torch, chk, y, cb, cr, lut, dbv, dbh, sao, alf, bd, 0, 0,
                  (True,) * 15, "10-bit 4:4:4 random", timed=False)


def capture_inter_inputs(MK, RK, Decoder):
    """Arguments of every MC, DMVR-search, final-pack and BDOF call of the
    port's own CUDA decode of the flagship RA stream (device tensors; the
    wrappers never write their inputs)."""
    patches = {"mc": (MK, "mc_tiles_pair"), "search": (RK, "dmvr_search"),
               "pack": (RK, "dmvr_final_pack"), "bdof": (RK, "bdof_blend_batch")}
    reals = {k: getattr(m, n) for k, (m, n) in patches.items()}
    got = {k: [] for k in patches}

    def recorder(key):
        def call(*args, **kw):
            got[key].append((args, kw))
            return reals[key](*args, **kw)
        return call

    for key, (mod, name) in patches.items():
        setattr(mod, name, recorder(key))
    try:
        dec = Decoder(device="cuda")
        dec.decode_stream(read_stream(RA_STREAM))
    finally:
        for key, (mod, name) in patches.items():
            setattr(mod, name, reals[key])
    if not dec.hash_results or not all(hr.ok for hr in dec.hash_results):
        raise AssertionError(f"{RA_STREAM}: hash mismatch while recording")
    empty = [k for k, v in got.items() if not v]
    if empty:
        raise AssertionError(f"{RA_STREAM}: no {empty} call recorded")
    return got


def check_inter_recorded(chk: KernelCheck, got, MK, RK):
    """The four inter kernels against their plain versions on the recorded
    inputs of the flagship decode (not timed: the batches are small)."""
    label = RA_STREAM
    for (largs, cargs, bd), _ in got["mc"]:
        for args, lum in ((largs, True), (cargs, False)):
            if args is None:
                continue
            taps, tile = MK.SHAPES[lum]
            kw = dict(taps=taps, tile=tile, bd=bd)
            chk.compare("vtm_mc_tiles",
                        f"{label} {'luma' if lum else 'chroma'}, {args[1].shape[0]} tiles",
                        lambda: MK.mc_tiles_cuda(*args, **kw),
                        lambda: MK.mc_tiles_plain(*args, **kw))
    for args, kw in got["search"]:
        chk.compare("vtm_dmvr_search", f"{label}, {args[0].shape[0]} sub-PUs",
                    lambda: RK.dmvr_search_cuda(*args, **kw),
                    lambda: RK.dmvr_search_plain(*args, **kw))
    for (l0, l1, cargs), kw in got["pack"]:
        jobs = [(a, dict(w=kw["w"], h=kw["h"], taps=8, bd=kw["bd"])) for a in (l0, l1)]
        jobs += [(a, dict(w=kw["wc"], h=kw["hc"], taps=4, bd=kw["bd"])) for a in cargs]
        for a, fk in jobs:
            chk.compare("vtm_fir_blocks",
                        f"{label}, {a[0].shape[0]} {fk['w']}x{fk['h']} blocks",
                        lambda: RK.fir_blocks_cuda(*a, **fk),
                        lambda: RK.fir_blocks_plain(*a, **fk))
    for args, kw in got["bdof"]:
        chk.compare("vtm_bdof_blend", f"{label}, {args[0].shape[0]} sub-blocks",
                    lambda: RK.bdof_blend_batch_cuda(*args, **kw),
                    lambda: RK.bdof_blend_batch_plain(*args, **kw))


def check_inter_1080p(chk: KernelCheck, MK, RK, dev, seed: int = 9):
    """The four inter kernels on numpy-seeded batches the size of a 1080p
    4:2:0 picture, timed: 129,600 luma 4x4 tiles over 4 reference planes
    of 1920x1080, 2 x 129,600 chroma 2x2 tiles over 4 of 960x540, and
    8,100 16x16 sub-PUs for the DMVR search, the luma FIR and BDOF."""
    import numpy as np

    from vtm_tpu_torch import testing as T
    from vtm_tpu_torch.ops.filter_chain import to_device

    rng = np.random.default_rng(seed)
    bd = 8

    def d(a):
        return to_device(a, dev)

    for lum, (h, w), n in ((True, (1080, 1920), 129_600),
                           (False, (540, 960), 2 * 129_600)):
        refs = np.stack([T.plane(rng, h, w, bd) for _ in range(4)])
        drefs = list(d(refs))
        args = [d(a) for a in T.mc_tiles_case(rng, refs, n, lum, bd, cover=True)]
        taps, tile = MK.SHAPES[lum]
        kw = dict(taps=taps, tile=tile, bd=bd)
        # separable FIR: (tile + taps - 1) x tile + tile x tile taps a tile
        macs = n * ((tile + taps - 1) * tile + tile * tile) * taps
        chk.compare("vtm_mc_tiles",
                    f"1080p seeded {'luma' if lum else 'chroma'}, {n} tiles",
                    lambda: MK.mc_tiles_cuda(drefs, *args, **kw),
                    lambda: MK.mc_tiles_plain(drefs, *args, **kw), timed=True,
                    ins=(drefs, args), ops=macs)
    label = "1080p seeded, 8100 16x16"
    kw = dict(bd=bd, dx=16, dy=16)
    args = [d(a) for a in T.dmvr_case(rng, 8100, 16, 16, bd)]
    # 25 offsets, a SAD over the even rows of a 16x16 sub-PU (3 ops a sample)
    chk.compare("vtm_dmvr_search", f"{label} sub-PUs",
                lambda: RK.dmvr_search_cuda(*args, **kw),
                lambda: RK.dmvr_search_plain(*args, **kw), timed=True,
                ins=args, ops=8100 * 25 * 128 * 3)
    kw = dict(w=16, h=16, taps=8, bd=bd)
    args = [d(a) for a in T.fir_blocks_case(rng, 8100, 8, 16, 16, bd)]
    chk.compare("vtm_fir_blocks", f"{label} luma blocks",
                lambda: RK.fir_blocks_cuda(*args, **kw),
                lambda: RK.fir_blocks_plain(*args, **kw), timed=True,
                ins=args, ops=8100 * (23 * 16 + 16 * 16) * 8)
    kw = dict(bd=bd, w=16, h=16)
    args = [d(a) for a in T.bdof_case(rng, 8100, 16, 16, bd)]
    chk.compare("vtm_bdof_blend", f"{label} sub-blocks",
                lambda: RK.bdof_blend_batch_cuda(*args, **kw),
                lambda: RK.bdof_blend_batch_plain(*args, **kw), timed=True,
                ins=args, ops=8100 * 256 * 30)


def satd_ops(RC, h: int, w: int) -> int:
    """Operations a sample of an h x w SATD takes at least: the butterflies
    of its tile (log2 of the tile's size) plus the absolute value and the
    sum; 2 for a block that falls back to the SAD."""
    kind = RC.satd_kind(h, w)
    if kind == RC.SAD:
        return 2
    th, tw = RC.KINDS[kind]
    return (th * tw).bit_length() - 1 + 2


def check_satd(chk: KernelCheck, dev, seed: int = 11):
    """vtm_satd_batch against its plain version on numpy-seeded differences
    of every tiling, 8- and 10-bit (with the all-max, all-min and
    checkerboard extremes), 1920x1080 samples per call, timed at 8 bits;
    and on tiles where float32 and float64 normalisation differ."""
    import numpy as np

    from vtm_tpu_torch import testing as T
    from vtm_tpu_torch.ops import rdcost as RC
    from vtm_tpu_torch.ops.filter_chain import to_device

    rng = np.random.default_rng(seed)
    for h, w in SATD_SHAPES:
        n = 1920 * 1080 // (h * w)
        for bd in (8, 10):
            d = to_device(T.satd_diffs(rng, n, h, w, bd), dev)
            chk.compare("vtm_satd_batch", f"{h}x{w} {bd}-bit, {n} blocks",
                        lambda: RC.satd_batch_cuda(d, h, w),
                        lambda: RC.satd_batch_plain(d, h, w), timed=bd == 8,
                        ins=d, ops=d.numel() * satd_ops(RC, h, w))
    for h, w in ((8, 16), (16, 8), (4, 8), (8, 4)):
        # tiles on which float32 and float64 normalisation differ
        d = to_device(T.satd_f32_cases(rng, h, w, 10), dev)
        chk.compare("vtm_satd_batch", f"{h}x{w}, {d.shape[0]} float32-edge tiles",
                    lambda: RC.satd_batch_cuda(d, h, w),
                    lambda: RC.satd_batch_plain(d, h, w))


def check_rmd(torch, chk: KernelCheck, src, bd: int, label: str, timed: bool):
    """The three RMD kernels against their plain versions on every class of
    the source picture `src` (MIP on): the angular and the MIP columns, and
    the reduction of the plain table."""
    import numpy as np

    from vtm_tpu_torch.encoder import rmd as RMD
    from vtm_tpu_torch.encoder.enc_lib import EncoderConfig
    from vtm_tpu_torch.ops import rdcost as RC
    from vtm_tpu_torch.ops import upload

    dev = torch.device("cuda")
    h_pic, w_pic = src.shape
    cfg = EncoderConfig(width=w_pic, height=h_pic, bit_depth=bd, mip=True)
    srcpad = np.pad(src.astype(np.int32), ((1, RMD.PAD_R), (1, RMD.PAD_R)),
                    mode="edge")
    total = 0
    for w, h in RMD.intra_class_list(cfg):
        sx, sy = RMD._class_strides(w, h)
        gx, gy = np.meshgrid(np.arange(0, w_pic - w + 1, sx),
                             np.arange(0, h_pic - h + 1, sy))
        sp, xs, ys = upload([srcpad, gx.ravel(), gy.ravel()], dev)
        c = RMD.class_consts(w, h, bd, True, dev)
        P = xs.shape[0]
        total += P
        out = torch.empty((P, c.ncols), dtype=torch.int32, device=dev)
        tag = f"{label} {w}x{h}, {P} positions"
        kw = dict(timed=timed, iters=2)
        # a prediction (4-tap: 4 ops) and its SATD per sample, mode and position
        per = h * w * (4 + satd_ops(RC, h, w))
        ang = chk.compare(
            "vtm_rmd_angular", tag,
            lambda: RMD.angular_costs_cuda(sp, xs, ys, c, out)[:, :RMD.N_ANG],
            lambda: RMD.angular_costs_plain(sp, xs, ys, c, w, h, bd), **kw,
            ins=(sp, xs, ys), ops=P * RMD.N_ANG * per)
        mip = chk.compare(
            "vtm_rmd_mip", tag,
            lambda: RMD.mip_costs_cuda(sp, xs, ys, c, out)[:, RMD.N_ANG:],
            lambda: RMD.mip_costs_plain(sp, xs, ys, c, w, h, bd), **kw,
            ins=(sp, xs, ys), ops=P * (c.ncols - RMD.N_ANG) * per)
        full = torch.cat([ang, mip], dim=1)
        chk.compare("vtm_rmd_reduce", tag,
                    lambda: RMD.reduce_cuda(full, c.n_mip),
                    lambda: RMD.reduce_plain(full, c.n_mip), **kw,
                    ins=full, ops=2 * full.numel())
    print(f"RMD [{label}]: {total} positions in all classes", flush=True)


def check_transforms(torch, chk: KernelCheck, dev, seed: int = 17):
    """Both inverse transform kernels against the plain version, and against
    each other, on numpy-seeded int16-range coefficients: for every block
    size and kind pair, a batch of as many blocks as tile a 1920x1080 plane,
    at 8 and 10 bits; timed on the square DCT2 sizes at 8 bits."""
    import numpy as np

    from vtm_tpu_torch.ops import transform as TR

    rng = np.random.default_rng(seed)
    sizes = (2, 4, 8, 16, 32, 64)
    cases = 0
    for h in sizes:
        for w in sizes:
            for tr_hor, tr_ver in TRANSFORM_KINDS:
                try:
                    TR._check_shape(h, w, tr_hor, tr_ver)
                except ValueError:
                    continue
                n = 1920 * 1080 // (h * w)
                c = torch.from_numpy(rng.integers(-32768, 32768, size=(n, h, w))
                                     .astype(np.int32)).to(dev)
                for bd in (8, 10):
                    args = (c, bd, tr_hor, tr_ver)
                    timed = bd == 8 and h == w and tr_hor == tr_ver == TR.DCT2
                    tag = f"{h}x{w} kinds {(tr_hor, tr_ver)} {bd}-bit, {n} blocks"
                    macs = n * h * w * (h + w)
                    plain = TR.inv_transform_batch_plain(*args)
                    a = chk.compare("vtm_inv_transform", tag,
                                    lambda: TR.inv_transform_batch_cuda(*args),
                                    lambda: TR.inv_transform_batch_plain(*args),
                                    timed, ins=c, ops=macs, quiet=not timed)
                    s = chk.compare("vtm_inv_transform_s8", tag,
                                    lambda: TR.inv_transform_batch_s8_cuda(*args),
                                    lambda: TR.inv_transform_batch_s8_plain(*args),
                                    timed, ins=c, ops=4 * macs,
                                    peak=INT8_TC_OPS_PER_S, quiet=not timed)
                    if not (torch.equal(a, s) and torch.equal(a, plain)):
                        raise AssertionError(f"vtm_inv_transform != vtm_inv_transform_s8 [{tag}]")
                    cases += 1
    print(f"inverse transforms: {cases} cases, vtm_inv_transform == "
          "vtm_inv_transform_s8 == plain on every one", flush=True)


def check_shard_entries(torch, chk: KernelCheck, pic: dict, dev, lanes: int = 8):
    """The luma deblocking delta and the extended-plane SAO on the `lanes`
    width shards of a captured 1080p picture, each with its neighbours'
    real halo (edge copies at the picture border), and the recon/SSE
    epilogue on two 1080p planes of 32x32 blocks; timed."""
    import numpy as np

    from vtm_tpu_torch.ops import deblock_kernel as DK
    from vtm_tpu_torch.ops import edge_pad
    from vtm_tpu_torch.ops import sao_kernel as SK
    from vtm_tpu_torch.parallel import mesh as MS
    from vtm_tpu_torch.parallel import multichip as MCH
    from vtm_tpu_torch.parallel import pic_shard as PS

    x, dv, _, sao, _, _ = MCH.luma_chain_args(pic)
    bd = int(pic["bd"])
    xs = PS._split_cols(PS._t(x), lanes, [dev] * lanes)
    dvs = list(zip(*(PS._split_cols(PS._t(m), lanes, [dev] * lanes) for m in dv)))
    for i, (e, maps) in enumerate(zip(PS._halo_cols(xs, 8), dvs)):
        chk.compare("vtm_deblock_luma_ver_delta", f"1080p POC 0 shard {i} of {lanes}",
                    lambda: DK.luma_ver_delta_cuda(e, *maps, bd),
                    lambda: DK.luma_ver_delta_plain(e, *maps, bd), timed=True,
                    ins=(e, maps), ops=10 * e.numel())
    if sao is not None:
        parts = [PS._split_cols(PS._t(m), lanes, [dev] * lanes) for m in (sao[0], sao[1], sao[3])]
        offs = PS._t(sao[2]).to(dev)
        for i, e in enumerate(PS._halo_cols(xs, 1)):
            pad = edge_pad(e, 1, 0)
            args = (pad, parts[0][i], parts[1][i], offs, parts[2][i], bd)
            chk.compare("vtm_sao_apply_ext", f"1080p POC 0 shard {i} of {lanes}",
                        lambda: SK.sao_apply_ext_cuda(*args),
                        lambda: SK.sao_apply_ext_plain(*args), timed=True,
                        ins=args[:5], ops=8 * parts[0][i].numel())
    rng = np.random.default_rng(23)
    shape = (2, 2040, 32, 32)
    resid, pred, orig = (torch.from_numpy(a.astype(np.int32)).to(dev) for a in (
        rng.integers(-300, 300, shape), rng.integers(0, 256, shape),
        rng.integers(0, 256, shape)))
    chk.compare("vtm_recon_sse", "2 x 2040 32x32 blocks",
                lambda: MS.recon_sse_cuda(resid, pred, orig),
                lambda: MS.recon_sse_plain(resid, pred, orig), timed=True,
                ins=(resid, pred, orig), ops=6 * resid.numel())


def spread(secs) -> str:
    """Median, least and most of a stage's host seconds."""
    s = sorted(secs)
    return (f"median {statistics.median(s):.6f} s (min {s[0]:.6f}, max {s[-1]:.6f}, "
            f"{len(s)} runs)")


def show_dryrun(rep: dict, one: dict) -> None:
    """A dry run's report: each stage's spread, and its median per picture
    over the one-lane run's (`one`)."""
    per = {"luma_chain_s": "luma_pictures", "mc_s": None,
           "full_chain_s": "full_chain_pictures"}
    parts = []
    for k, pics in per.items():
        if k not in rep:
            continue
        ratio = (statistics.median(rep[k]) / (rep[pics] if pics else 1)) / (
            statistics.median(one[k]) / (one[pics] if pics else 1))
        parts.append(f"{k[:-2]} {spread(rep[k])}, {ratio:.4f}x one lane"
                     + (" per picture" if pics else ""))
    what = {k: v for k, v in rep.items() if k not in per}
    print(f"dryrun_multichip {rep['stream']} {what}: " + "; ".join(parts), flush=True)


def mesh_path(torch, KN, hd_cap: dict, dev) -> dict:
    """The multi-device main path on lanes sharing the card; returns its
    launch counts.  Its inputs come first: the decodes that capture the
    small208 and RA streams, the seeded MC batch, and the plain results the
    MC and recon stages are held to.  Then the counts are zeroed, and only
    the sharded calls and their one-lane runs follow.  Every lane is held to
    its picture's single-lane result; every stage runs REPEATS times, and
    its host seconds (inputs uploaded, result fetched) are printed as
    median, min and max beside the one-lane run's."""
    import numpy as np

    from vtm_tpu_torch import testing as T
    from vtm_tpu_torch.ops import mc_kernel as MK
    from vtm_tpu_torch.ops import transform as TR
    from vtm_tpu_torch.parallel import mesh as MS
    from vtm_tpu_torch.parallel import multichip as MCH
    from vtm_tpu_torch.parallel import pic_shard as PS

    # ---- inputs, and the results they are held to ----
    small_cap = MCH.capture_decode(MCH.STREAM, "cuda")
    ra = MCH.capture_decode(RA_STREAM, "cuda")["mc"]
    rng = np.random.default_rng(29)
    refs = np.stack([T.plane(rng, 1080, 1920, 8) for _ in range(4)])
    args = (refs,) + T.mc_tiles_case(rng, refs, 129_600, True, 8, cover=True)
    planes = [torch.from_numpy(p).to(dev) for p in refs]
    jobs = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in args[1:]]
    seeded = dict(args=args, taps=8, tile=4, bd=8,
                  out=MK.mc_tiles_plain(planes, *jobs, taps=8, tile=4, bd=8).cpu().numpy())
    # two 1080p luma planes of 32x32 blocks for the reconstruction step
    shape = (2, 2040, 32, 32)
    coeff = rng.integers(-2048, 2048, size=shape).astype(np.int32)
    pred = rng.integers(0, 256, size=shape).astype(np.int32)
    orig = np.clip(pred + rng.integers(-20, 21, size=shape), 0, 255).astype(np.int32)
    c, p, o = (torch.from_numpy(a).to(dev) for a in (coeff, pred, orig))
    resid = TR.inv_transform_batch_plain(c.reshape(-1, 32, 32), 8).reshape(shape)
    want_recon, want_sse = MS.recon_sse_plain(resid, p, o)
    want_recon, want_sse = want_recon.cpu(), want_sse.to(torch.float32).cpu()
    torch.cuda.synchronize()

    # ---- the path: sharded calls and their one-lane runs alone ----
    KN.reset_launch_counts()
    for stream, cap, cases in ((HD_STREAM, hd_cap, ((1, 1), (4, 2), (8, 8))),
                               (MCH.STREAM, small_cap, ((1, None), (2, None), (8, None)))):
        one = None
        for n, tile in cases:
            rep = MCH.dryrun_multichip(n, device="cuda", stream=stream, tile=tile,
                                       cap=cap, repeats=REPEATS)
            one = one or rep
            show_dryrun(rep, one)
    # the MC job axis over 4 lanes: a 1080p-sized seeded batch, a slice batch
    # of the flagship RA stream
    for label, mc in (("1080p seeded, 129600 luma tiles", seeded),
                      (f"{RA_STREAM} slice, {ra['out'].shape[0]} luma tiles", ra)):
        one = None
        for n in (1, 4):
            mesh = MS.codec_mesh(n, device="cuda")
            got, secs = MCH.timed_runs(
                lambda: PS.sharded_mc_tiles(mesh, mc).cpu().numpy(), REPEATS)
            if not np.array_equal(got, mc["out"]):
                raise AssertionError(f"sharded MC mismatch ({label}, {n} lanes)")
            one = one or secs
            print(f"sharded_mc_tiles [{label}] on {n} lanes: equal to the single-lane "
                  f"result, {spread(secs)}, "
                  f"{statistics.median(secs) / statistics.median(one):.4f}x one lane",
                  flush=True)
    # the sharded reconstruction step, against the plain transform and recon
    one = None
    for n in (1, 4):
        mesh = MS.codec_mesh(n, gop=min(n, 2), device="cuda")
        (recon, sse), secs = MCH.timed_runs(
            lambda: tuple(t.cpu() for t in MS.sharded_recon_step(mesh, coeff, pred, orig)),
            REPEATS)
        if not (torch.equal(recon, want_recon) and torch.equal(sse, want_sse)):
            raise AssertionError(f"sharded_recon_step on {n} lanes != the plain result")
        one = one or secs
        print(f"sharded_recon_step {shape} on {mesh.gop} x {mesh.tile} lanes: equal to "
              f"the plain result, SSE {float(sse[0])}, {spread(secs)}, "
              f"{statistics.median(secs) / statistics.median(one):.4f}x one lane",
              flush=True)
    return KN.launch_counts()


def encode_small(torch, KN, Decoder, IntraEncoder, name: str, kw: dict) -> dict:
    """One 208x120 picture on the card and on the CPU: identical bytes, and
    the card's stream decodes hash-exact (on the card) to the encoder's
    reconstruction.  Returns the launches of the card's encode alone."""
    from vtm_tpu_torch import testing as T
    from vtm_tpu_torch.encoder.enc_lib import EncoderConfig

    frames = [T.read_source(name, 208, 120)]
    before = KN.launch_counts()
    t0 = time.perf_counter()
    enc = IntraEncoder(EncoderConfig(width=208, height=120, **kw), device="cuda")
    bits = enc.encode(frames)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    after = KN.launch_counts()
    cpu_bits = IntraEncoder(EncoderConfig(width=208, height=120, **kw),
                            device="cpu").encode(frames)
    if bits != cpu_bits:
        raise AssertionError(f"encode {name}: cuda and cpu streams differ "
                             f"({len(bits)} vs {len(cpu_bits)} bytes)")
    check_own_decode(Decoder, name, bits, enc.last_recon)
    done = KN.launch_counts()
    enc_l = {k: after[k] - before[k] for k in after if after[k] > before[k]}
    dec_l = {k: done[k] - after[k] for k in after if done[k] > after[k]}
    print(f"encode {name} {kw}: {len(bits)} bytes, identical on cuda and cpu, "
          f"decoded hash-exact; {dt:.4f} s on cuda; launches: encode {enc_l}, "
          f"decode of its stream {dec_l}", flush=True)
    return {k: after[k] - before[k] for k in after}


def check_own_decode(Decoder, name: str, bits: bytes, recon) -> None:
    import numpy as np

    dec = Decoder(device="cuda")
    pics = dec.decode_stream(bits)
    if len(pics) != 1 or len(dec.hash_results) != 1 or not dec.hash_results[0].ok:
        raise AssertionError(f"encode {name}: the port's decoder does not "
                             "verify the stream's hash")
    if not all(np.array_equal(p, r) for p, r in zip(pics[0].planes, recon)):
        raise AssertionError(f"encode {name}: decoded picture != encoder recon")


def encode_hd(torch, KN, Decoder, IntraEncoder):
    """One 1920x1080 picture (mirror-tiled bq416) at QP 37 with bench.py's
    configuration on the card; decoded hash-exact by the port.  Prints
    s/picture and its split: the host's wait for FrameRMD's results, the
    deblocking stage, the rest (host RD search, CABAC); and FrameRMD's span
    on the device timeline (CUDA events around its construction: uploads,
    kernels and the gaps while the host prepares the next class).  Returns
    the launches of the encode alone."""
    from vtm_tpu_torch import testing as T
    from vtm_tpu_torch.encoder import rmd as RMD
    from vtm_tpu_torch.encoder.enc_lib import EncoderConfig
    from vtm_tpu_torch.ops import deblock as DBP

    spans = {"rmd_events": [], "rmd_wait": 0.0, "deblock": 0.0}
    real_rmd, real_db = RMD.FrameRMD, DBP.deblock_picture

    class TimedFrameRMD(real_rmd):
        def __init__(self, *args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            super().__init__(*args, **kw)
            end.record()
            spans["rmd_events"].append((start, end))

        def _force_reduced(self):
            t0 = time.perf_counter()
            out = super()._force_reduced()
            spans["rmd_wait"] += time.perf_counter() - t0
            return out

    def timed_deblock(*args, **kw):
        t0 = time.perf_counter()
        real_db(*args, **kw)
        spans["deblock"] += time.perf_counter() - t0

    frames = [T.hd_source()]
    before = KN.launch_counts()
    RMD.FrameRMD, DBP.deblock_picture = TimedFrameRMD, timed_deblock
    try:
        t0 = time.perf_counter()
        enc = IntraEncoder(EncoderConfig(width=1920, height=1080, qp=37),
                           device="cuda")
        bits = enc.encode(frames)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        RMD.FrameRMD, DBP.deblock_picture = real_rmd, real_db
    after = KN.launch_counts()
    check_own_decode(Decoder, "hd_source 1920x1080", bits, enc.last_recon)
    rmd_ms = sum(s.elapsed_time(e) for s, e in spans["rmd_events"])
    rest = dt - spans["rmd_wait"] - spans["deblock"]
    print(f"encode 1920x1080 (bq416 mirror-tiled) QP 37: {len(bits)} bytes, "
          f"decoded hash-exact; {dt:.4f} s/picture = FrameRMD wait "
          f"{spans['rmd_wait']:.4f} s + deblock {spans['deblock']:.4f} s + host "
          f"RD and CABAC {rest:.4f} s; FrameRMD span on the device timeline "
          f"{rmd_ms:.4f} ms (CUDA events: uploads, kernels, host gaps)", flush=True)
    return {k: after[k] - before[k] for k in after}


def decode(torch, Decoder, name: str, chain_events: list) -> int:
    """Decode one stream on the card, check every picture hash, and print
    seconds per picture and the chain's summed device time."""
    chain_events.clear()
    data = read_stream(name)
    t0 = time.perf_counter()
    dec = Decoder(device="cuda")
    pics = dec.decode_stream(data)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if not pics or len(dec.hash_results) != len(pics):
        raise AssertionError(f"{name}: {len(pics)} pictures, "
                             f"{len(dec.hash_results)} hashes")
    bad = [hr.poc for hr in dec.hash_results if not hr.ok]
    if bad:
        raise AssertionError(f"{name}: hash mismatch at POC {bad}")
    chain_ms = [s.elapsed_time(e) for s, e in chain_events]
    h, w = pics[0].planes[0].shape
    print(f"decode {name} ({w}x{h}): {len(pics)} pictures, hashes OK, "
          f"{dt / len(pics):.4f} s/picture; filter chain {sum(chain_ms):.4f} ms "
          f"device time in all, per picture {[round(m, 4) for m in chain_ms]} "
          "(CUDA events, uploads included)", flush=True)
    return len(pics)


def main() -> int:
    import torch

    # 1. the card
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    print(card_line(), flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}", flush=True)
    sys.path.insert(0, ROOT)
    import numpy as np

    from vtm_tpu_torch import kernels as KN
    from vtm_tpu_torch import testing as T
    from vtm_tpu_torch.decoder.declib import Decoder
    from vtm_tpu_torch.encoder.enc_lib import IntraEncoder
    from vtm_tpu_torch.ops import filter_chain as FC
    from vtm_tpu_torch.ops import mc_kernel as MK
    from vtm_tpu_torch.ops import refine_kernel as RK
    from vtm_tpu_torch.parallel import multichip as MCH

    # 2. build
    t0 = time.perf_counter()
    diag = KN.build(force=True, ptxas_verbose=True)
    KN.library()
    print(f"built {os.path.relpath(KN.LIB_PATH, ROOT)} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for line in diag.splitlines():
        entry = re.search(r"entry function '_Z(\d+)(\w+)'", line)
        if entry:
            print("  ptxas:", entry.group(2)[:int(entry.group(1))])
        elif "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    # 3. kernels against their plain versions
    chk = KernelCheck(torch)
    # the chain inputs of both pictures of the 1080p stream (decoded on the
    # card, hashes checked); POC 0's feed the kernel checks, both the
    # multi-device path of phase 6
    hd_cap = MCH.capture_decode(HD_STREAM, "cuda")
    pic0 = hd_cap["pics"][0]
    planes, lmcs_lut, dmaps, sao_maps, alf_tables, bd, sx, sy = (pic0[k] for k in (
        "planes", "lmcs_lut", "dmaps", "sao_maps", "alf_tables", "bd", "sx", "sy"))
    dev = torch.device("cuda")
    fl = FC.chain_flags(len(planes), lmcs_lut, dmaps, sao_maps, alf_tables)
    print(f"POC 0 chain flags {fl}", flush=True)
    y, cb, cr = (FC.to_device(p, dev) for p in planes)
    dbv, dbh, sao, alf = FC.maps_to_torch(dmaps, sao_maps, alf_tables, dev)
    lut = FC.to_device(lmcs_lut, dev) if lmcs_lut is not None else None
    check_kernels(torch, chk, y, cb, cr, lut, dbv, dbh, sao, alf, bd, sx, sy,
                  fl, "1080p POC 0", timed=True)
    random_case(torch, chk, dev)
    check_inter_recorded(chk, capture_inter_inputs(MK, RK, Decoder), MK, RK)
    check_inter_1080p(chk, MK, RK, dev)
    check_satd(chk, dev)
    check_rmd(torch, chk, T.hd_source()[0], 8, "1080p bq416 mirror-tiled", timed=True)
    check_rmd(torch, chk, T.rmd_source(np.random.default_rng(13), 192, 256, 10),
              10, "10-bit 256x192 seeded", timed=False)
    check_transforms(torch, chk, dev)
    check_shard_entries(torch, chk, pic0, dev)

    # 4. the decode main path, with the launch counts of this run only
    chain_events = []
    real_chain = FC.run_filter_chain

    def timed_chain(*args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = real_chain(*args, **kw)
        end.record()
        chain_events.append((start, end))
        return out

    FC.run_filter_chain = timed_chain
    KN.reset_launch_counts()
    try:
        per_stream = {}
        for name in (HD_STREAM,) + SMALL_STREAMS + INTER_STREAMS:
            before = KN.launch_counts()
            n_pics = decode(torch, Decoder, name, chain_events)
            after = KN.launch_counts()
            per_stream[name] = ({k: after[k] - before[k] for k in after}, n_pics)
    finally:
        FC.run_filter_chain = real_chain
    dec_counts = KN.launch_counts()
    hd, n_hd = per_stream[HD_STREAM]
    print(f"launches, {HD_STREAM}: {hd}", flush=True)
    ra, _ = per_stream[RA_STREAM]
    print(f"launches, {RA_STREAM}: {ra}", flush=True)
    print(f"launches, decode main path: {dec_counts}", flush=True)
    if hd["vtm_deblock_luma_ver"] < 2 * n_hd:
        raise AssertionError("luma deblock ran fewer than twice per picture")
    if hd["vtm_sao_apply"] < 1 or hd["vtm_alf_filter"] < 1 \
            or hd["vtm_alf_classify"] < 1:
        raise AssertionError("SAO or ALF did not run on the 1080p stream")
    if any(ra[k] < 1 for k in INTER_KERNELS):
        raise AssertionError(f"an inter kernel did not run on {RA_STREAM}")

    # 5. the encode main path, with the launch counts of this run only
    KN.reset_launch_counts()
    encodes = [encode_small(torch, KN, Decoder, IntraEncoder, name, kw)
               for name, kw in ENC_CASES]
    encodes.append(encode_hd(torch, KN, Decoder, IntraEncoder))
    enc_counts = KN.launch_counts()
    enc_only = {k: sum(c[k] for c in encodes) for k in enc_counts}
    print(f"launches, the encodes alone: {enc_only}", flush=True)
    print(f"launches, encode main path (the encodes and the decodes of their "
          f"streams): {enc_counts}", flush=True)
    idle = [k for k in ENC_KERNELS if enc_only[k] == 0]
    if idle:
        raise AssertionError(f"the encodes did not launch {idle}")
    for k, why in NOT_IN_ENCODER.items():
        print(f"{k}: not launched by the encoder: {why}", flush=True)

    # 6. the multi-device main path, with the launch counts of this run only
    mesh_counts = mesh_path(torch, KN, hd_cap, dev)
    print(f"launches, multi-device main path: {mesh_counts}", flush=True)
    idle = [k for k in MESH_KERNELS if mesh_counts[k] == 0]
    if idle:
        raise AssertionError(f"the multi-device path did not launch {idle}")
    counts = {k: dec_counts[k] + enc_counts[k] + mesh_counts[k] for k in dec_counts}
    for k, why in NOT_ON_MAIN_PATH.items():
        print(f"{k}: not launched by name on the main path: {why}", flush=True)
    missing = [k for k, v in counts.items() if v == 0 and k not in NOT_ON_MAIN_PATH]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")

    # 7. results
    kernels = []
    for name, (source, replaces) in KERNEL_INFO.items():
        row = chk.rows[name]
        bound_ms, bound_by = chk.bound(name)
        print(f"bound {name}: {row['bytes']} bytes / {BYTES_PER_S:.4g} B/s = "
              f"{row['bytes'] / BYTES_PER_S * 1e3:.6f} ms; {row['ops']:.6g} ops / "
              f"{row['peak']:.4g} op/s = {row['ops'] / row['peak'] * 1e3:.6f} ms; "
              f"kernel {row['ms']:.6f} ms", flush=True)
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces, launches=counts[name],
                            max_abs_err=row["max_abs_err"], ms=row["ms"],
                            plain_ms=row["plain_ms"], bound_ms=bound_ms,
                            bound_by=bound_by, library_ms=None))
    torch.cuda.synchronize()
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
