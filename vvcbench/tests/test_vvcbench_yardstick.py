"""The yardstick's arithmetic: the chain's operations against chip_smoke.py's
per-kernel counts on captured pictures, its bytes by hand, and the trace
reduction on crafted intervals."""

import importlib.util
import os

import pytest

from vvcbench import devtrace, manifest, yardstick

FLAGS = 15


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(manifest.ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class OpsRecorder:
    """chip_smoke's KernelCheck in the shape check_kernels calls it: records
    each kernel's counted operations and runs the plain version."""

    def __init__(self):
        self.ops = 0

    def compare(self, kernel, label, cuda_fn, plain_fn, timed=False, ins=(), ops=0, **kw):
        if "seeded" not in label:  # a case the chain itself never runs
            self.ops += ops
        return plain_fn()


def test_peaks_equal_chip_smokes():
    cs = load_chip_smoke()
    assert yardstick.BYTES_PER_S == cs.BYTES_PER_S
    assert yardstick.INT32_OPS_PER_S == cs.INT32_OPS_PER_S


@pytest.mark.parametrize("stream", ["ra_full_small208_qp32", "ai_ccalf_cc208_qp32",
                                    "ai422_small208_qp32"])
def test_chain_ops_equal_chip_smokes(stream):
    """Every picture whose chain runs ALF (check_kernels takes only those):
    the frozen count equals the sum of chip_smoke.check_kernels's
    per-kernel operations, stage by stage."""
    import torch

    from vtm_tpu_torch.ops import filter_chain as FC
    from vtm_tpu_torch.parallel import multichip as MCH

    cs = load_chip_smoke()
    pics = [p for p in MCH.capture_decode(stream, "cpu")["pics"]
            if p["alf_tables"] is not None]
    assert pics
    for pic in pics:
        rec = OpsRecorder()
        fl = cs.chain_flags(pic)
        y, cb, cr = (FC.to_device(p, "cpu") for p in pic["planes"])
        dbv, dbh, sao, alf = FC.maps_to_torch(pic["dmaps"], pic["sao_maps"],
                                              pic["alf_tables"], "cpu")
        lut = (FC.to_device(pic["lmcs_lut"], "cpu") if pic["lmcs_lut"] is not None
               else None)
        cs.check_kernels(torch, rec, y, cb, cr, lut, dbv, dbh, sao, alf, pic["bd"],
                         pic["sx"], pic["sy"], fl, stream, timed=True)
        shapes = [p.shape for p in pic["planes"]]
        assert yardstick.chain_work(shapes, pic["bd"], fl, 128)[1] == rec.ops


def test_chain_bytes_by_hand():
    shapes = [(1080, 1920), (540, 960), (540, 960)]
    y, c = 1920 * 1080, 2 * 960 * 540
    off = (False,) * FLAGS
    assert yardstick.chain_work(shapes, 10, off, 128) == (2 * 2 * (y + c), 0)
    assert yardstick.chain_work(shapes, 8, off, 128) == (2 * (y + c), 0)
    n_ctu = 15 * 9  # 1920 / 128 by 1080 / 128, rounded up
    every = (True,) * FLAGS
    nbytes, ops = yardstick.chain_work(shapes, 10, every, 128)
    assert ops == 2 * 10 * (y + c) + 8 * (y + c) + 60 * y + 2 * (24 + 14) * (c // 2)
    assert nbytes == (4 * (y + c) + 1024 * 2 + 2 * (y + c) // 32 + 3 * 6 * n_ctu
                      + 5 * n_ctu + 600 + 2 * 96 + 2 * 28)
    t = yardstick.least_s(nbytes, ops)
    assert t == max(nbytes / 3.35e12, ops / (132 * 64 * 1.98e9))


def test_union_of_overlapping_intervals():
    iv = [(0, 10), (5, 15), (20, 30), (25, 26), (30, 31), (40, 40)]
    assert devtrace.union(iv) == [(0, 15), (20, 31), (40, 40)]
    assert devtrace.busy_ns(iv) == 26
    # summing the durations would count the overlaps twice
    assert sum(e - s for s, e in iv) == 32


def test_gaps_and_labels():
    busy = devtrace.union([(10, 20), (15, 30), (50, 60)])
    assert devtrace.gaps(busy, 0, 100) == [(0, 10), (30, 50), (60, 100)]
    assert devtrace.gaps(busy, 10, 60) == [(30, 50)]
    spans = [("stream", 0, 100), ("slice", 20, 55), ("finish", 56, 90)]
    assert devtrace.label(spans, 40) == "slice"
    assert devtrace.label(spans, 70) == "finish"
    assert devtrace.label(spans, 100) == "harness"


def test_idle_share_and_breakdown():
    ops = [("void sao_kernel<false>(int const*, int*)", 10, 20),
           ("void alf_filter_kernel<true>(int const*)", 15, 30),
           ("Memcpy HtoD (Pageable -> Device)", 50, 60)]
    tr = devtrace.Trace(window=(0, 100), device_ops=ops,
                        spans=[("slice", 0, 40), ("finish", 40, 100)])
    assert devtrace.busy_ns((s, e) for _, s, e in tr.device_ops) == 30
    reader = manifest.reader("device_idle_pct.decode")

    class R:
        trace = tr
    assert reader(R) == pytest.approx(70.0)
    b = devtrace.breakdown(tr)
    assert b["device_ops"] == [["alf_filter_kernel<true>", 15e-9], ["sao_kernel<false>", 10e-9],
                               ["Memcpy HtoD (Pageable -> Device)", 10e-9]]
    assert b["idle_gaps"] == [["finish", 40e-9], ["finish", 20e-9], ["slice", 10e-9]]
    assert devtrace.family_s(tr, {"sao_kernel", "alf_filter_kernel"}) == pytest.approx(25e-9)


class Ev:
    """A recorded event in the shape torch.profiler's kineto events give."""

    def __init__(self, name, dev, kind, s, e, corr=0, linked=0, tid=1):
        self._v = dict(name=name, device_type=dev, activity_type=kind, start_ns=s, end_ns=e,
                       correlation_id=corr, linked_correlation_id=linked, start_thread_id=tid,
                       is_user_annotation=kind.endswith("user_annotation"))

    def __getattr__(self, k):
        return lambda: self._v[k]


def test_device_ops_attributed_to_the_range_they_were_launched_in():
    """The chain's device time is every operation launched inside the
    "vvcbench.chain" range, whatever its name: found by the correlation id
    of its CUDA API call, else by the host operation it is linked to; work
    launched outside the range, or on another thread while it is open, is
    not the chain's."""
    CPU, CUDA = "cpu", "cuda"
    events = [
        Ev("vvcbench.window", CPU, "user_annotation", 0, 1000, corr=1),
        Ev("vvcbench.finish", CPU, "user_annotation", 100, 600, corr=2),
        Ev("vvcbench.chain", CPU, "user_annotation", 200, 400, corr=3),
        Ev("vvcbench.chain", CPU, "user_annotation", 700, 800, corr=4),
        # inside the first chain range: a hand-written kernel, an aten index
        # kernel, a copy; the aten kernel found through its linked host op
        Ev("cudaLaunchKernel", CPU, "cuda_runtime", 210, 215, corr=501),
        Ev("void sao_kernel<false>(int*)", CUDA, "kernel", 300, 310, corr=501),
        Ev("aten::index", CPU, "cpu_op", 220, 230, corr=5),
        Ev("void at::native::index_elementwise_kernel", CUDA, "kernel", 310, 330, linked=5),
        Ev("cuLaunchKernel", CPU, "cuda_runtime", 240, 241, corr=502),
        Ev("Memset (Device)", CUDA, "gpu_memset", 320, 325, corr=502),
        # the same thread, outside the ranges: the maps' upload
        Ev("cudaMemcpyAsync", CPU, "cuda_runtime", 150, 160, corr=503),
        Ev("Memcpy HtoD (Pageable -> Device)", CUDA, "gpu_memcpy", 160, 190, corr=503),
        # another thread while the range is open
        Ev("cudaLaunchKernel", CPU, "cuda_runtime", 250, 251, corr=504, tid=2),
        Ev("void mc_tiles_kernel(int*)", CUDA, "kernel", 400, 450, corr=504),
        # inside the second range; it ends after the window and is clipped
        Ev("cudaLaunchKernel", CPU, "cuda_runtime", 790, 791, corr=505),
        Ev("void alf_filter_kernel<true>(int*)", CUDA, "kernel", 990, 1010, corr=505),
        # a device op with no host partner is nobody's
        Ev("void ccalf_kernel(int*)", CUDA, "kernel", 500, 510, corr=999),
        # the device's copies of ranges are neither operations nor ranges
        Ev("vvcbench.chain", CUDA, "gpu_user_annotation", 300, 330),
        Ev("vvcbench.window", CUDA, "gpu_user_annotation", 160, 1000),
    ]
    tr = devtrace.reduce_events(events, CUDA)
    assert tr.window == (0, 1000)
    assert len(tr.device_ops) == len(tr.launched) == 7
    assert [s[0] for s in tr.spans] == ["finish", "chain", "chain"]
    chain = devtrace.under(tr, "chain")
    assert [n for n, _, _ in chain] == [
        "void sao_kernel<false>(int*)", "void at::native::index_elementwise_kernel",
        "Memset (Device)", "void alf_filter_kernel<true>(int*)"]
    # sao 300-310, index 310-330 (overlapping the set 320-325), alf 990-1000
    assert devtrace.under_s(tr, "chain") == pytest.approx(40e-9)
    assert len(devtrace.under(tr, "finish")) == 4  # the upload too; not the other thread's


def test_kernel_names():
    name = "void luma_tile_kernel<false, true>(int*, int, Maps<(int)3>)"
    assert devtrace.kernel_base(name) == "luma_tile_kernel"
    assert devtrace.kernel_short(name) == "luma_tile_kernel<false, true>"
    assert devtrace.kernel_base("ccalf_kernel(int const*, int)") == "ccalf_kernel"
