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
4. the main path through vtm_tpu_torch.decoder.declib.Decoder(device=
   "cuda"): the 1080p all-intra stream, three small all-intra streams
   (10-bit, 4:2:2, CC-ALF) and three inter streams (the flagship RA stream,
   LD-B with every tool, IBC), every picture hash checked, with launch
   counts that prove the decode ran through every kernel;
5. one JSON line of per-kernel results, then the device line, last.
"""

from __future__ import annotations

import json
import os
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
                             "vtm_tpu/ops/deblock_kernel.py:68"),
    "vtm_deblock_chroma_ver": ("vtm_tpu_torch/csrc/deblock.cu",
                               "vtm_tpu/ops/deblock_kernel.py:350"),
    "vtm_sao_apply": ("vtm_tpu_torch/csrc/sao.cu",
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
}


class _Captured(Exception):
    pass


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters: int = 10) -> float:
    """Mean device time of fn() in ms (CUDA events, after a warm-up)."""
    for _ in range(2):
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


def capture_chain_inputs(FC, Decoder, device: str):
    """Host-side chain inputs of the first picture of the 1080p stream."""
    real = FC.run_filter_chain
    got = {}

    def grab(planes, *args):
        got["args"] = ([p.copy() for p in planes],) + args
        raise _Captured

    FC.run_filter_chain = grab
    try:
        Decoder(device=device).decode_stream(read_stream(HD_STREAM))
    except _Captured:
        pass
    finally:
        FC.run_filter_chain = real
    if "args" not in got:
        raise AssertionError("no filter chain input captured")
    return got["args"]


class KernelCheck:
    """Per-kernel results: largest deviation from the plain version and
    the two times, summed over the cases that time the kernel."""

    def __init__(self, torch):
        self.torch = torch
        self.rows = {k: dict(max_abs_err=0, ms=0.0, plain_ms=0.0)
                     for k in KERNEL_INFO}

    def compare(self, kernel: str, label: str, cuda_fn, plain_fn,
                timed: bool = False):
        torch = self.torch
        got = cuda_fn()
        want = plain_fn()
        torch.cuda.synchronize()
        err = max_err(torch, got, want)
        row = self.rows[kernel]
        row["max_abs_err"] = max(row["max_abs_err"], err)
        msg = f"{kernel} [{label}]: max |kernel - plain| = {err}"
        if timed:
            ms, pms = cuda_ms(torch, cuda_fn), cuda_ms(torch, plain_fn)
            row["ms"] += ms
            row["plain_ms"] += pms
            msg += f", kernel {ms:.4f} ms, plain {pms:.4f} ms"
        print(msg, flush=True)
        if err:
            raise AssertionError(f"{kernel} [{label}] disagrees with its plain version")
        return got


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
                lambda: DK.deblock_dir_plain(y, cb, cr, *maps, **lk)[0], timed)
        if hcb or hcr:
            ck = dict(kw, has_l=False, has_cb=hcb, has_cr=hcr)
            _, cb, cr = chk.compare(
                "vtm_deblock_chroma_ver", tag,
                lambda: DK.deblock_dir_cuda(y, cb, cr, *maps, **ck),
                lambda: DK.deblock_dir_plain(y, cb, cr, *maps, **ck), timed)
    planes = [y, cb, cr]
    for comp, on in enumerate((s0, s1, s2)):
        if on:
            p, m = planes[comp], sao[comp]
            planes[comp] = chk.compare(
                "vtm_sao_apply", f"{label} comp {comp}",
                lambda: SK.sao_apply_cuda(p, *m, bit_depth=bd),
                lambda: SK.sao_apply_plain(p, *m, bit_depth=bd), timed)
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
            lambda: AK.classify_picture_plain(y_pad, *rows, bit_depth=bd), timed)
        gather = (ctu_of.long(), cls.long(), tr.long())
        coef, clip = cperm[gather], lperm[gather]
        chk.compare(
            "vtm_alf_filter", f"{label} luma",
            lambda: AK.alf_filter_cuda(y_pad, coef, clip, l_orows, l_near,
                                       taps=AK.LUMA_TAPS, bit_depth=bd),
            lambda: AK.alf_filter_plain(y_pad, coef, clip, l_orows, l_near,
                                        taps=AK.LUMA_TAPS, bit_depth=bd), timed)
    for on, c, co, cl in ((a_cb, cb, cb_coef, cb_clip), (a_cr, cr, cr_coef, cr_clip)):
        if on:
            c_pad = edge_pad(c, AK.PAD, AK.PAD)
            chk.compare(
                "vtm_alf_filter", f"{label} chroma",
                lambda: AK.alf_filter_cuda(c_pad, co, cl, c_orows, c_near,
                                           taps=AK.CHROMA_TAPS, bit_depth=bd),
                lambda: AK.alf_filter_plain(c_pad, co, cl, c_orows, c_near,
                                            taps=AK.CHROMA_TAPS, bit_depth=bd),
                timed)
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
            timed)
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
        chk.compare("vtm_mc_tiles",
                    f"1080p seeded {'luma' if lum else 'chroma'}, {n} tiles",
                    lambda: MK.mc_tiles_cuda(drefs, *args, **kw),
                    lambda: MK.mc_tiles_plain(drefs, *args, **kw), timed=True)
    label = "1080p seeded, 8100 16x16"
    kw = dict(bd=bd, dx=16, dy=16)
    args = [d(a) for a in T.dmvr_case(rng, 8100, 16, 16, bd)]
    chk.compare("vtm_dmvr_search", f"{label} sub-PUs",
                lambda: RK.dmvr_search_cuda(*args, **kw),
                lambda: RK.dmvr_search_plain(*args, **kw), timed=True)
    kw = dict(w=16, h=16, taps=8, bd=bd)
    args = [d(a) for a in T.fir_blocks_case(rng, 8100, 8, 16, 16, bd)]
    chk.compare("vtm_fir_blocks", f"{label} luma blocks",
                lambda: RK.fir_blocks_cuda(*args, **kw),
                lambda: RK.fir_blocks_plain(*args, **kw), timed=True)
    kw = dict(bd=bd, w=16, h=16)
    args = [d(a) for a in T.bdof_case(rng, 8100, 16, 16, bd)]
    chk.compare("vtm_bdof_blend", f"{label} sub-blocks",
                lambda: RK.bdof_blend_batch_cuda(*args, **kw),
                lambda: RK.bdof_blend_batch_plain(*args, **kw), timed=True)


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
    from vtm_tpu_torch import kernels as KN
    from vtm_tpu_torch.decoder.declib import Decoder
    from vtm_tpu_torch.ops import filter_chain as FC
    from vtm_tpu_torch.ops import mc_kernel as MK
    from vtm_tpu_torch.ops import refine_kernel as RK

    # 2. build
    t0 = time.perf_counter()
    diag = KN.build(force=True, ptxas_verbose=True)
    KN.library()
    print(f"built {os.path.relpath(KN.LIB_PATH, ROOT)} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for line in diag.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    # 3. kernels against their plain versions
    chk = KernelCheck(torch)
    planes, lmcs_lut, dmaps, sao_maps, alf_tables, bd, sx, sy, _ = \
        capture_chain_inputs(FC, Decoder, "cuda")
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

    # 4. the main path, with the launch counts of this run only
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
    counts = KN.launch_counts()
    hd, n_hd = per_stream[HD_STREAM]
    print(f"launches, {HD_STREAM}: {hd}", flush=True)
    ra, _ = per_stream[RA_STREAM]
    print(f"launches, {RA_STREAM}: {ra}", flush=True)
    print(f"launches, whole main path: {counts}", flush=True)
    if hd["vtm_deblock_luma_ver"] < 2 * n_hd:
        raise AssertionError("luma deblock ran fewer than twice per picture")
    if hd["vtm_sao_apply"] < 1 or hd["vtm_alf_filter"] < 1 \
            or hd["vtm_alf_classify"] < 1:
        raise AssertionError("SAO or ALF did not run on the 1080p stream")
    if any(ra[k] < 1 for k in INTER_KERNELS):
        raise AssertionError(f"an inter kernel did not run on {RA_STREAM}")
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")

    # 5. results
    kernels = []
    for name, (source, replaces) in KERNEL_INFO.items():
        row = chk.rows[name]
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces, launches=counts[name],
                            max_abs_err=row["max_abs_err"], ms=row["ms"],
                            plain_ms=row["plain_ms"]))
    torch.cuda.synchronize()
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
