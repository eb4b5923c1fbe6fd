"""The SATD, RMD, deblocking, MC, FIR and ALF-filter CUDA sources, built for
the CPU by the test-support emulation of tests/_emu, against their plain
torch versions.

No card and no nvcc here, so the kernels themselves run on the chip only
(chip_smoke.py and the `cuda` tests hold them to the plain versions there).
This checks the same C++ — the per-class instantiations, the compact class
table, the shared-memory layout, the warp SATD (its shuffles emulated), the
native column order, the transposed hor group, MIP's upsampling, the
reduction's first argmin — one std::thread per CUDA thread, on a few
positions of every class, and on strips of positions that fill one block
and end part-way into the next; and the deblocking tiles (halos, decisions
in shared memory, Cb and Cr in one launch) through the port's own wrappers
on planes of several tiles each way with ragged right and bottom tiles;
the MC tile groups (plane pointers by value, windows and passes in shared
memory), the FIR job groups (up to six a launch, spans staged in shared
memory from any alignment), the RMD reduction's warp reductions (crafted
ties) and the ALF filter tiles (a template per component, halo rows and
columns, out-of-halo row offsets read from the plane) through their
wrappers.  Tolerance 0.
"""

import ctypes
import os
import shutil

import numpy as np
import pytest
import torch

from vtm_tpu.encoder.enc_lib import EncoderConfig
from vtm_tpu.encoder.rmd_tpu import intra_class_list
from vtm_tpu_torch import kernels as KN
from vtm_tpu_torch import testing as T
from vtm_tpu_torch.encoder import rmd as RMD
from vtm_tpu_torch.ops import alf_kernel as AK
from vtm_tpu_torch.ops import deblock_kernel as DK
from vtm_tpu_torch.ops import mc_kernel as MK
from vtm_tpu_torch.ops import rdcost as RC
from vtm_tpu_torch.ops import refine_kernel as RK

PIC_H, PIC_W = 80, 96
CLASSES = intra_class_list(EncoderConfig(width=PIC_W, height=PIC_H))


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("the CPU emulation of the CUDA sources needs g++")
    from _emu import build

    return build.load(str(tmp_path_factory.mktemp("emu")),
                      ["rdcost.cu", "rmd.cu", "deblock.cu", "mc.cu", "alf.cu",
                       "refine.cu"])


def test_satd_batch(lib):
    rng = np.random.default_rng(31)
    for h, w in [(2, 2), (4, 4), (8, 8), (16, 16), (8, 16), (16, 8), (4, 8),
                 (8, 4), (4, 16), (32, 8), (64, 64), (3, 5)]:
        for bd in (8, 10):
            d = torch.from_numpy(T.satd_diffs(rng, 5, h, w, bd))
            out = torch.full((5,), -1, dtype=torch.int32)
            assert lib.vtm_satd_batch(d.data_ptr(), out.data_ptr(), 5, h, w, None) == 0
            np.testing.assert_array_equal(out.numpy(),
                                          RC.satd_batch_plain(d, h, w).numpy())
    # tiles on which float32 and float64 normalisation differ
    for h, w in [(8, 16), (16, 8), (4, 8), (8, 4)]:
        d = torch.from_numpy(T.satd_f32_cases(rng, h, w, 10))
        out = torch.empty((d.shape[0],), dtype=torch.int32)
        assert lib.vtm_satd_batch(d.data_ptr(), out.data_ptr(), d.shape[0], h, w,
                                  None) == 0
        np.testing.assert_array_equal(out.numpy(),
                                      RC.satd_batch_plain(d, h, w).numpy())


@pytest.mark.parametrize("bd", [8, 10])
def test_rmd_kernels(lib, bd):
    rng = np.random.default_rng(bd)
    src = T.rmd_source(rng, PIC_H, PIC_W, bd)
    sp = torch.from_numpy(np.pad(src, ((1, RMD.PAD_R), (1, RMD.PAD_R)), mode="edge"))
    for w, h in CLASSES:
        xs, ys = (torch.from_numpy(a)
                  for a in T.rmd_positions(rng, 2, PIC_W, PIC_H, w, h))
        for mip in (False, True):
            c = RMD.class_consts(w, h, bd, mip, "cpu")
            out = torch.full((2, c.ncols), -1, dtype=torch.int32)
            red = torch.full((2, 5), -1, dtype=torch.int32)
            pos = (sp.data_ptr(), *sp.shape, xs.data_ptr(), ys.data_ptr(), 2)
            assert lib.vtm_rmd_angular(*pos, c.tab.data_ptr(), w, h, bd,
                                       out.data_ptr(), c.ncols, None) == 0
            if mip:
                assert lib.vtm_rmd_mip(*pos, c.wadj.data_ptr(), c.n_mip, w, h,
                                       bd, out.data_ptr(), c.ncols, None) == 0
            assert lib.vtm_rmd_reduce(out.data_ptr(), 2, c.ncols, 2 * c.n_mip,
                                      red.data_ptr(), None) == 0
            want_out, want_red = RMD.class_costs_plain(sp, xs, ys, c, w, h, bd, mip)
            np.testing.assert_array_equal(out.numpy(), want_out.numpy())
            np.testing.assert_array_equal(red.numpy(), want_red.numpy())


def _strip_classes():
    """Classes whose angular or MIP kernel takes several positions a block."""
    return [c for c in CLASSES if c[0] * c[1] <= 256]


@pytest.mark.parametrize("w,h", _strip_classes())
def test_rmd_kernels_strips(lib, w, h):
    """The positions of the class's grid in the main path's order (x
    fastest): the first ones (the top edge, the left and right edges and
    the start of the next row) and the last ones (the bottom-right corner),
    one block and a part of the next for the kernel that takes the most
    positions a block, 10-bit."""
    bd = 10
    cfg = RMD.kernel_config(w, h, lib)
    npb = max(cfg["angular"]["positions_per_block"], cfg["mip"]["positions_per_block"])
    assert npb > 1
    src = T.rmd_source(np.random.default_rng(w * h), PIC_H, PIC_W, bd)
    sp = torch.from_numpy(np.pad(src, ((1, RMD.PAD_R), (1, RMD.PAD_R)), mode="edge"))
    sx, sy = RMD._class_strides(w, h)
    gx, gy = np.meshgrid(np.arange(0, PIC_W - w + 1, sx), np.arange(0, PIC_H - h + 1, sy))
    gx, gy = gx.ravel().astype(np.int32), gy.ravel().astype(np.int32)
    take = np.r_[np.arange(npb + 2), np.arange(len(gx) - npb - 1, len(gx))]
    xs, ys = torch.from_numpy(gx[take]), torch.from_numpy(gy[take])
    P = len(take)
    c = RMD.class_consts(w, h, bd, True, "cpu")
    out = torch.full((P, c.ncols), -1, dtype=torch.int32)
    pos = (sp.data_ptr(), *sp.shape, xs.data_ptr(), ys.data_ptr(), P)
    assert lib.vtm_rmd_angular(*pos, c.tab.data_ptr(), w, h, bd, out.data_ptr(),
                               c.ncols, None) == 0
    assert lib.vtm_rmd_mip(*pos, c.wadj.data_ptr(), c.n_mip, w, h, bd,
                           out.data_ptr(), c.ncols, None) == 0
    want, _ = RMD.class_costs_plain(sp, xs, ys, c, w, h, bd, True)
    np.testing.assert_array_equal(out.numpy(), want.numpy())


def test_rmd_refuses_other_classes(lib):
    """Each class is its own instantiation: another size is refused, and so
    is a MIP table of another class's mode count."""
    c = RMD.class_consts(8, 8, 8, True, "cpu")
    z = torch.zeros((64, 64), dtype=torch.int32)
    xs = torch.zeros(1, dtype=torch.int32)
    out = torch.zeros((1, c.ncols), dtype=torch.int32)
    pos = (z.data_ptr(), 64, 64, xs.data_ptr(), xs.data_ptr(), 1)
    assert lib.vtm_rmd_angular(*pos, c.tab.data_ptr(), 8, 2, 8, out.data_ptr(),
                               c.ncols, None) != 0
    assert lib.vtm_rmd_mip(*pos, c.wadj.data_ptr(), c.n_mip + 1, 8, 8, 8,
                           out.data_ptr(), c.ncols, None) != 0
    with pytest.raises(RuntimeError, match="vtm_rmd_config"):
        RMD.kernel_config(64, 8, lib)


# deblocking: a luma plane of 2 x 9 VER tiles (128 columns x 16 rows) and
# 7 x 3 HOR tiles (32 columns x 64 rows), the last ones ragged; chroma tiles
# are 64 x 32 and 32 x 64, several each way and ragged in every format
DB_H, DB_W = 136, 200


@pytest.fixture
def emu_launch(lib, monkeypatch):
    """The wrappers' launches go to the emulated library (CPU tensors)."""
    def launch(name, device, *args):
        err = getattr(lib, name)(*args, None)
        if err:
            raise RuntimeError(f"{name}: error {err}")
    monkeypatch.setattr(KN, "launch", launch)


def _deblock_maps(rng, bd, hor, shift):
    """testing.deblock_maps with the active edges moved `shift` map steps
    off the 16-sample grid: still 16 luma samples apart, so no two edges
    write one sample, but with shift 1 and 3 on the tiles' halo edges x0+TA+4
    and x0-4 (with 0 on the tile borders)."""
    maps = list(T.deblock_maps(rng, DB_H, DB_W, bd, hor))
    r, c = np.mgrid[0:DB_H // 4, 0:DB_W // 4]
    grid = (r if hor else c) % 4 == shift
    for i in (0, 7, 10):  # the luma, Cb and Cr activity maps
        maps[i] = (rng.random(grid.shape) < 0.85) & grid
    return [torch.from_numpy(np.ascontiguousarray(m)) for m in maps]


@pytest.mark.parametrize("hor", [False, True])
@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("fmt", ["420", "422", "444"])
def test_deblock_dir(emu_launch, fmt, bd, hor):
    """vtm_deblock_luma_ver and vtm_deblock_chroma_ver (Cb and Cr in one
    launch, and Cb alone) against deblock_dir_plain, with edges on the tile
    borders and on the halo edges."""
    rng = np.random.default_rng(100 * bd + 10 * hor + len(fmt))
    sx, sy = T.FORMATS[fmt]
    y, cb, cr = (torch.from_numpy(p) for p in T.planes(rng, DB_H, DB_W, fmt, bd))
    for shift in (0, 1, 3):
        maps = _deblock_maps(rng, bd, hor, shift)
        for has_cr in (True, False) if shift == 0 else (True,):
            kw = dict(bit_depth=bd, hor=hor, has_l=True, has_cb=True,
                      has_cr=has_cr, sx=sx, sy=sy)
            got = DK.deblock_dir_cuda(y, cb, cr, *maps, **kw)
            want = DK.deblock_dir_plain(y, cb, cr, *maps, **kw)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), w.numpy())
        assert not torch.equal(want[0], y), "no luma edge was filtered"
        step = DK._chroma_geometry(hor, sx, sy)[2]  # luma map steps a chroma edge
        assert shift % step or not torch.equal(want[1], cb), "no chroma edge was filtered"


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("loop_len,dec_line", [(2, 1), (4, 3)])
def test_deblock_chroma_ver(emu_launch, loop_len, dec_line, aligned):
    """The single-plane entry (null second plane) on maps of the chroma
    segment grid, against chroma_ver_core; also on a plane 4 bytes off a
    16-byte boundary (sample loads and stores, no vectors)."""
    rng = np.random.default_rng(loop_len)
    hc, wc = DB_H // 2, DB_W // 2
    buf = torch.empty(hc * wc + 4, dtype=torch.int32)
    plane = buf[0 if aligned else 1:][:hc * wc].view(hc, wc)
    plane.copy_(torch.from_numpy(T.plane(rng, hc, wc, 10)))
    assert (plane.data_ptr() % 16 == 0) == aligned
    full = T.deblock_maps(rng, hc // loop_len * 4, wc, 10, False)
    maps = [torch.from_numpy(np.ascontiguousarray(m)) for m in full[7:10] + full[13:17]]
    got = DK._chroma_seg_cuda([plane], [maps[:3]], maps[3:], maps[0], 10, False,
                              loop_len, dec_line)[0]
    want = DK.chroma_ver_core(plane, *maps, 10, loop_len, dec_line)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert not torch.equal(want, plane)


@pytest.mark.parametrize("bd", [8, 10])
def test_deblock_luma_ver_delta(emu_launch, bd):
    """The delta form over an 8-column-extended shard, against
    luma_ver_delta_plain."""
    rng = np.random.default_rng(40 + bd)
    pad = torch.from_numpy(T.plane(rng, DB_H, DB_W + 16, bd))
    maps = [torch.from_numpy(m) for m in T.deblock_maps(rng, DB_H, DB_W, bd, False)[:7]]
    got = DK.luma_ver_delta_cuda(pad, *maps, bd)
    want = DK.luma_ver_delta_plain(pad, *maps, bd)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert want.any()


def _misaligned(a: np.ndarray, aligned: bool = False) -> torch.Tensor:
    """`a` as a contiguous int32 tensor, 4 bytes off a 16-byte boundary
    unless `aligned`."""
    buf = torch.empty(a.size + 4, dtype=torch.int32)
    off = (-buf.data_ptr() // 4) % 4 + (0 if aligned else 1)
    t = buf[off:off + a.size].view(a.shape)
    t.copy_(torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)))
    assert (t.data_ptr() % 16 == 0) == aligned
    return t


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("lum", [True, False])
def test_mc_tiles(emu_launch, lum, bd):
    """vtm_mc_tiles through mc_tiles_cuda against mc_tiles_plain: 3 planes,
    windows off every plane edge, uni and bi, one group of tiles and a part
    of the next; then into an output 4 bytes off a 16-byte boundary."""
    rng = np.random.default_rng(60 + bd + lum)
    taps, tile = MK.SHAPES[lum]
    group = 256 // (4 if lum else 2)  # tiles a block (csrc/mc.cu McShape::G)
    refs = np.stack([T.plane(rng, 24, 40, bd) for _ in range(3)])
    planes = list(torch.from_numpy(refs))
    n = group + group // 2 + 3
    args = [torch.from_numpy(a) for a in T.mc_tiles_case(rng, refs, n, lum, bd)]
    kw = dict(taps=taps, tile=tile, bd=bd)
    want = MK.mc_tiles_plain(planes, *args, **kw)
    got = MK.mc_tiles_cuda(planes, *args, **kw)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    out = _misaligned(np.full((n, tile, tile), -1))
    MK.mc_tiles_cuda(planes, *args, **kw, out=out)
    np.testing.assert_array_equal(out.numpy(), want.numpy())


def test_mc_tiles_plane_cap(lib, emu_launch):
    """MAX_PLANES planes reach the kernel by value, every one read; one more
    is refused by the wrapper, and by the C entry point."""
    rng = np.random.default_rng(66)
    R, n = MK.MAX_PLANES, 300
    refs = np.stack([T.plane(rng, 8, 12, 8) for _ in range(R)])
    planes = list(torch.from_numpy(refs))
    args = [torch.from_numpy(a) for a in T.mc_tiles_case(rng, refs, n, True, 8)]
    args[0] = torch.from_numpy(np.arange(n, dtype=np.int32) % R)
    kw = dict(taps=8, tile=4, bd=8)
    np.testing.assert_array_equal(MK.mc_tiles_cuda(planes, *args, **kw).numpy(),
                                  MK.mc_tiles_plain(planes, *args, **kw).numpy())
    with pytest.raises(ValueError, match="at most 256"):
        MK.mc_tiles_cuda(planes + planes[:1], *args, **kw)
    table = (ctypes.c_void_p * (R + 1))(*(p.data_ptr() for p in planes + planes[:1]))
    out = torch.empty((n, 4, 4), dtype=torch.int32)
    assert lib.vtm_mc_tiles(ctypes.addressof(table), R + 1, 8, 12,
                            *(a.data_ptr() for a in args), n, 8, 4, 8,
                            out.data_ptr(), None) != 0


# the ALF filter's tiles are 64 columns x 16 rows (luma) or 8 rows (chroma):
# a plane of 3 x 3 luma and 3 x 5 chroma tiles, the right and bottom ragged
ALF_H, ALF_W = 36, 136


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("luma", [True, False])
def test_alf_filter(emu_launch, luma, bd, aligned):
    """vtm_alf_filter<LUMA> through alf_filter_cuda against
    alf_filter_plain: VB rows in every CTU row, an ALF-off CTU row (zero
    coefficients), two row offsets past the halo (read from the plane,
    clamped), and with aligned=False the plane and the coefficient and clip
    maps 4 bytes off a 16-byte boundary (scalar loads)."""
    rng = np.random.default_rng(70 + 4 * bd + 2 * luma + aligned)
    ctu, n = (16, 12) if luma else (8, 6)
    src = T.plane(rng, ALF_H, ALF_W, bd)
    coef = rng.integers(-64, 65, size=(ALF_H // 4, ALF_W // 4, n))
    clip = rng.integers(0, 1 << bd, size=(ALF_H // 4, ALF_W // 4, n))
    coef[ctu // 4:2 * ctu // 4] = 0  # an ALF-off CTU row: identity there
    o_rows, near = AK.vb_row_offsets(ALF_H, ctu, ctu - (4 if luma else 2), luma)
    o_rows[5, 2], o_rows[34, 3] = 9, -40  # past the halo: a malformed table
    taps = AK.LUMA_TAPS if luma else AK.CHROMA_TAPS
    pad = _misaligned(np.pad(src, AK.PAD, mode="edge"), aligned)
    maps = [_misaligned(m, aligned) for m in (coef, clip)]
    rows = (torch.from_numpy(o_rows), torch.from_numpy(near))
    got = AK.alf_filter_cuda(pad, *maps, *rows, taps=taps, bit_depth=bd)
    want = AK.alf_filter_plain(pad, *maps, *rows, taps=taps, bit_depth=bd)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(want.numpy()[ctu:2 * ctu], src[ctu:2 * ctu])
    assert near.any() and not np.array_equal(want.numpy(), src)


def _reduce_rows(rng, n_mip: int) -> np.ndarray:
    """Cost rows of 67 + 2 n_mip columns with crafted ties: at lane 0 (column
    0 against 40), at lane 31 (31 against 63), across the 32-column
    boundaries (32 against 64, 33 against 1), between the MIP columns (the
    first against the last, two in one lane), and rows of a few values
    (ties everywhere), of all INT32_MAX and of negative costs."""
    ncols = RMD.N_ANG + 2 * n_mip
    big = np.iinfo(np.int32).max
    rows = [rng.integers(1000, 5000, ncols) for _ in range(6)]
    for cols in ((0, 40), (31, 63), (32, 64), (1, 33), (63, 66), (66, 64)):
        r = rng.integers(1000, 5000, ncols)
        r[list(cols)] = 7
        rows.append(r)
    if n_mip:
        m = 2 * n_mip
        for cols in ((0, m - 1), (m - 1, 0), (m // 2, m - 1)):
            r = rng.integers(1000, 5000, ncols)
            r[[RMD.N_ANG + c for c in cols]] = 3
            rows.append(r)
    rows += [rng.integers(0, 3, ncols) for _ in range(4)]
    rows += [np.full(ncols, big), rng.integers(-(1 << 31), 0, ncols)]
    return np.stack(rows).astype(np.int32)


@pytest.mark.parametrize("n_mip", [0, 6, 8, 16])
def test_rmd_reduce(emu_launch, n_mip):
    """vtm_rmd_reduce (a warp a position) through reduce_cuda against
    reduce_plain on crafted ties, on more positions than the grid has warps
    (the stub's one SM: 8 blocks of 8), so that each warp walks several;
    a column count that does not add up is refused."""
    rng = np.random.default_rng(80 + n_mip)
    rows = _reduce_rows(rng, n_mip)
    out = torch.from_numpy(np.concatenate([rows, rng.permutation(np.tile(rows, (8, 1)))]))
    assert out.shape[0] > 2 * 64 + 8 and out.shape[1] % 32
    np.testing.assert_array_equal(RMD.reduce_cuda(out, n_mip).numpy(),
                                  RMD.reduce_plain(out, n_mip).numpy())
    with pytest.raises(RuntimeError, match="vtm_rmd_reduce"):
        RMD.KN.launch("vtm_rmd_reduce", out.device, out.data_ptr(), 1, out.shape[1],
                      2 * n_mip + 2, out.data_ptr())


def _fir_case(rng, n, taps, w, h, bd):
    return [torch.from_numpy(a) for a in T.fir_blocks_case(rng, n, taps, w, h, bd)]


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("taps,w,h", [(8, 16, 8), (8, 8, 16), (4, 8, 8), (4, 4, 8)])
def test_fir_blocks(emu_launch, taps, w, h, bd):
    """vtm_fir_blocks through fir_blocks_cuda against fir_blocks_plain:
    one block of jobs and part of the next (ragged N), origins past every
    buffer edge, buffers whose spans start at every word offset of 16 bytes
    (the jobs' buffers of odd size, and the whole set 4 bytes off), and an
    output 4 bytes off a 16-byte boundary."""
    rng = np.random.default_rng(90 + bd + taps + w)
    per_block = 256 // w  # jobs a thread block (one thread a column)
    n = per_block + per_block // 2 + 3
    args = _fir_case(rng, n, taps, w, h, bd)
    assert (args[0].shape[1] * args[0].shape[2]) % 2  # odd spans: every lead
    kw = dict(w=w, h=h, taps=taps, bd=bd)
    want = RK.fir_blocks_plain(*args, **kw)
    np.testing.assert_array_equal(RK.fir_blocks_cuda(*args, **kw).numpy(), want.numpy())
    args[0] = _misaligned(args[0].numpy())
    out = _misaligned(np.full((n, h, w), -1))
    RK.fir_blocks_cuda(*args, **kw, out=out)
    np.testing.assert_array_equal(out.numpy(), want.numpy())


@pytest.fixture
def fir_launches(emu_launch, monkeypatch):
    """The emulated launches, counted; dmvr_final_pack takes its card
    branch on CPU tensors."""
    calls = []
    launch = KN.launch

    def counted(name, device, *args):
        calls.append(name)
        launch(name, device, *args)
    monkeypatch.setattr(KN, "launch", counted)
    monkeypatch.setattr(RK, "pick", lambda t, on_card, plain: on_card)
    return calls


@pytest.mark.parametrize("bd", [8, 10])
def test_dmvr_final_pack_one_launch(fir_launches, lib, bd):
    """dmvr_final_pack's six groups (both lists' luma, 8 taps, and four
    chroma groups, 4 taps) in one launch equal six one-group launches and
    the plain version; a seventh group is refused by the wrapper and by the
    C entry point, and so is a group of another tap count."""
    rng = np.random.default_rng(95 + bd)
    n = 21
    l0, l1 = (_fir_case(rng, n, 8, 16, 16, bd) for _ in range(2))
    cargs = [_fir_case(rng, n, 4, 8, 8, bd) for _ in range(4)]
    kw = dict(w=16, h=16, wc=8, hc=8, bd=bd)
    got = RK.dmvr_final_pack(l0, l1, cargs, **kw)
    assert fir_launches == ["vtm_fir_blocks"]
    ones = [RK.fir_blocks_cuda(*a, w=16, h=16, taps=8, bd=bd) for a in (l0, l1)]
    ones += [RK.fir_blocks_cuda(*a, w=8, h=8, taps=4, bd=bd) for a in cargs]
    assert len(fir_launches) == 7
    np.testing.assert_array_equal(got.numpy(), torch.cat([o.view(-1) for o in ones]).numpy())
    plain = [RK.fir_blocks_plain(*a, w=16, h=16, taps=8, bd=bd) for a in (l0, l1)]
    plain += [RK.fir_blocks_plain(*a, w=8, h=8, taps=4, bd=bd) for a in cargs]
    np.testing.assert_array_equal(got.numpy(), torch.cat([p.view(-1) for p in plain]).numpy())
    groups = [(tuple(a), 8, 8, 4, 0) for a in cargs + cargs[:3]]
    with pytest.raises(ValueError, match="at most 6"):
        RK.fir_groups_cuda(groups, bd, torch.empty(n * 64, dtype=torch.int32))
    out = torch.empty(n * 64, dtype=torch.int32)
    for count, taps in ((7, 4), (1, 6)):
        ptrs = (ctypes.c_void_p * (5 * count))(*(p.data_ptr() for a in (cargs * 2)[:count]
                                                 for p in a))
        dims = (ctypes.c_int * (7 * count))(*([n, 11, 11, 8, 8, taps, 0] * count))
        assert lib.vtm_fir_blocks(count, ctypes.addressof(ptrs), ctypes.addressof(dims), bd,
                                  out.data_ptr(), None) != 0
