"""The SATD, RMD, deblocking, MC, FIR, BDOF, ALF and transform CUDA sources, built for
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
ties), the ALF filter tiles (a template per component, halo rows and
columns, out-of-halo row offsets read from the plane), the ALF classifier's
tiles (a staged band of rows, gradients once, out-of-band row indices, the
int32 wrap), the luma deblocking delta tiles (every element written, halo
deltas) through their wrappers, the BDOF entry (every sub-block size,
ragged counts, extreme predictions, unaligned pointers), and the inverse
transform's register-tiled CTAs (square blocks in groups, a persistent CTA
walking several groups, ragged last groups) beside its general kernel
(every other shape, and unaligned pointers), with the reconstruction
epilogue.  The deblocking kernels' precondition, disjoint luma filter
extents, is checked in linear time (tests/_deblock_maps.py), held to the
pairwise check here.  Tolerance 0.
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
from vtm_tpu_torch.ops import transform as TR
from vtm_tpu_torch.parallel import mesh as MS

import _deblock_maps as DM

PIC_H, PIC_W = 80, 96
CLASSES = intra_class_list(EncoderConfig(width=PIC_W, height=PIC_H))


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("the CPU emulation of the CUDA sources needs g++")
    from _emu import build

    return build.load(str(tmp_path_factory.mktemp("emu")),
                      ["rdcost.cu", "rmd.cu", "deblock.cu", "mc.cu", "alf.cu",
                       "refine.cu", "transform.cu"])


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


def _strong_end_edges(rng, pad: np.ndarray, maps: list, bd: int) -> None:
    """The first and last edge of map rows 0-1 (extended columns 8 and
    Wp - 12) made long-filter edges (max_p, max_q 7, a step of 40 between
    flat sides), so that their deltas reach into the 8-column halos; the
    edges within 16 samples of the last one turned off, so that no two
    edges write one sample."""
    scale = 1 << (bd - 8)
    wp = pad.shape[1]
    w4 = (wp - 16) // 4
    base = int(rng.integers(100, 150)) * scale
    for x in (8, wp - 12):
        cols = np.arange(x - 8, x + 8)
        pad[0:8, x - 8:x + 8] = base + 40 * scale * (cols >= x)
    act, tc, beta, max_p, max_q, no_p, no_q = maps
    act[0:2, w4 - 4:w4 - 1] = False
    for c in (0, w4 - 1):
        act[0:2, c], tc[0:2, c], beta[0:2, c] = True, 25 * scale, 88 * scale
        max_p[0:2, c], max_q[0:2, c], no_p[0:2, c], no_q[0:2, c] = 7, 7, False, False


@pytest.mark.parametrize("bd", [8, 10])
def test_deblock_luma_ver_delta(lib, emu_launch, bd):
    """The delta form over an 8-column-extended shard, against
    luma_ver_delta_plain: through the wrapper, and through the C entry into
    a buffer filled with a sentinel (one launch must write every element,
    halo columns and unfiltered samples included: no memset precedes it);
    long filters on the first and last edge put deltas into both halos;
    widths of 1 + 11/16 tiles and of a part of one (the tile is 128
    columns), and a plane 4 bytes off a 16-byte boundary.  The maps meet the
    kernels' precondition, disjoint filter extents."""
    for h, w, aligned in ((DB_H, DB_W, True), (DB_H, DB_W, False), (40, 84, False)):
        rng = np.random.default_rng(40 + bd + w)
        raw = T.plane(rng, h, w + 16, bd)
        maps = list(T.deblock_maps(rng, h, w, bd, False)[:7])
        _strong_end_edges(rng, raw, maps, bd)
        assert DM.extents_disjoint(maps) and DM.extents_disjoint_pairs(maps)
        bad = [m.copy() for m in maps]  # two long filters 4 samples apart overlap
        bad[0][0, 0:2], bad[4][0, 0], bad[3][0, 1] = True, 7, 7
        assert not DM.extents_disjoint(bad) and not DM.extents_disjoint_pairs(bad)
        pad = _misaligned(raw, aligned)
        maps = [torch.from_numpy(m) for m in maps]
        want = DK.luma_ver_delta_plain(pad, *maps, bd)
        assert want[:, :8].any() and want[:, -8:].any(), "no halo deltas"
        got = DK.luma_ver_delta_cuda(pad, *maps, bd)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
        out = torch.full_like(want, -12345)
        assert lib.vtm_deblock_luma_ver_delta(pad.data_ptr(), out.data_ptr(), h, w + 16,
                                              *(m.data_ptr() for m in maps), bd,
                                              None) == 0
        np.testing.assert_array_equal(out.numpy(), want.numpy())


@pytest.mark.parametrize("seed", range(4))
def test_extents_disjoint_linear_equals_pairs(seed):
    """The linear precondition check agrees with the pairwise one on
    seeded maps of every density, with and without overlapping extents."""
    rng = np.random.default_rng(seed)
    seen = set()
    for density in (0.0, 0.05, 0.2, 0.5, 1.0):
        for _ in range(25):
            h4, w4 = rng.integers(1, 9), rng.integers(1, 40)
            act = rng.random((h4, w4)) < density
            max_p, max_q = (rng.integers(0, 8, (h4, w4)) for _ in range(2))
            maps = [act, None, None, max_p, max_q]
            got = DM.extents_disjoint(maps)
            assert got == DM.extents_disjoint_pairs(maps)
            seen.add(got)
    assert seen == {True, False}


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


# the classifier's tiles are 32 x 8 4x4 blocks (128 columns x 32 rows): a
# 248-column shard padded as pic_shard pads it (4-column halos, 4 edge rows
# above and below) is one full and one ragged tile across, 72 rows three
# tile rows, the last ragged
CLS_H, CLS_W = 72, 240


def _classify_rows(h: int, ctu: int):
    """The classification row tables of a picture of h rows with CTUs of
    `ctu` rows (the luma virtual boundary 4 rows above each CTU's end)."""
    return [torch.from_numpy(np.asarray(a))
            for a in AK.classify_row_indices(h, ctu, ctu - 4)
            + AK.classify_block_rows(h, ctu, ctu - 4)]


@pytest.mark.parametrize("bd,ctu,aligned", [(8, 32, True), (10, 64, False),
                                            (10, 16, True)])
def test_alf_classify(emu_launch, bd, ctu, aligned):
    """vtm_alf_classify through classify_picture_cuda against
    classify_picture_plain on a 248-column shard: VB rows at CTU heights
    16, 32 and 64, four row-table entries outside the band a tile stages
    (read from the plane, one clamped below 0), one past the plane's end and
    two in the band but far from their rows' own (in the part of the band
    staged last), and with aligned=False the plane 4 bytes off a 16-byte
    boundary."""
    rng = np.random.default_rng(110 + bd + ctu)
    src = T.plane(rng, CLS_H, CLS_W + 8, bd)
    pad = _misaligned(np.pad(src, ((AK.PAD, AK.PAD), (0, 0)), mode="edge"), aligned)
    rows = _classify_rows(CLS_H, ctu)
    y_i, yd_i, yu_i, yu2_i = rows[:4]
    yd_i[3], yu_i[9], yu2_i[20], y_i[30] = 50, 60, -7, 3
    y_i[-1] = 10 ** 5
    yu2_i[2], yd_i[19] = 24, 63  # in the band, far from the rows' own
    got = AK.classify_picture_cuda(pad, *rows, bit_depth=bd)
    want = AK.classify_picture_plain(pad, *rows, bit_depth=bd)
    assert want[0].shape == (CLS_H // 4, CLS_W // 4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    assert rows[4].any() and rows[5].any() and len(set(want[0].flatten().tolist())) > 3


def test_alf_classify_int32_wrap(emu_launch, monkeypatch):
    """A 10-bit plane whose left half repeats a 4x4 pattern of 0 and 1023:
    there a block's diagonal sum times its lesser horizontal or vertical
    sum passes 2^31, so the direction test's int32 product wraps; the
    kernel classifies as the plain version (and jax) does, and the plain
    version without the wrap classifies those blocks otherwise."""
    rng = np.random.default_rng(120)
    h, w = 40, 120
    tile = np.array([[1023, 0, 1023, 1023], [1023, 0, 1023, 0],
                     [1023, 0, 1023, 0], [1023, 0, 1023, 1023]])
    pad = T.plane(rng, h + 8, w + 8, 10)
    pad[:, :64] = np.tile(tile, ((h + 8) // 4, 16))
    pad = torch.from_numpy(pad)
    rows = _classify_rows(h, 64)
    got = AK.classify_picture_cuda(pad, *rows, bit_depth=10)
    want = AK.classify_picture_plain(pad, *rows, bit_depth=10)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w_.numpy())
    monkeypatch.setattr(AK, "mul32", lambda a, b: a.long() * b.long())
    unwrapped = AK.classify_picture_plain(pad, *rows, bit_depth=10)
    assert not torch.equal(unwrapped[0], want[0])


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


def _bdof_counts(w: int, h: int) -> tuple:
    """Sub-block counts: one, and counts around multiples of the sub-blocks
    that 256 threads of 4 samples each would cover (a group less one, a
    group and a part of the next, three groups and one)."""
    group = 256 // (w * h // 4)
    return tuple(n for n in (1, group - 1, group + group // 2 + 1, 3 * group + 1) if n)


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("w,h", [(8, 8), (16, 8), (8, 16), (16, 16)])
def test_bdof_blend(lib, emu_launch, w, h, bd):
    """vtm_bdof_blend against bdof_blend_batch_plain: ragged sub-block
    counts, through the wrapper; through the C entry into an output filled
    with a sentinel; extreme predictions (the 14-bit domain's ends, and
    int32's)."""
    rng = np.random.default_rng(110 + 2 * w + h + bd)
    lo, hi = -(1 << 13), (1 << 14) + (1 << 13) - 1
    for n in _bdof_counts(w, h):
        p0, p1 = (torch.from_numpy(a) for a in T.bdof_case(rng, n, w, h, bd))
        want = RK.bdof_blend_batch_plain(p0, p1, bd, w, h)
        got = RK.bdof_blend_batch_cuda(p0, p1, bd, w, h)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
        out = torch.full((n, h, w), -12345, dtype=torch.int32)
        assert lib.vtm_bdof_blend(p0.data_ptr(), p1.data_ptr(), n, w, h, bd,
                                  out.data_ptr(), None) == 0
        np.testing.assert_array_equal(out.numpy(), want.numpy())
    n = _bdof_counts(w, h)[2]
    for ends in ((lo, hi), (-(1 << 31), (1 << 31) - 1)):
        p0, p1 = (torch.from_numpy(rng.choice(np.array(ends, dtype=np.int32),
                                              (n, h + 2, w + 2)))
                  for _ in range(2))
        np.testing.assert_array_equal(RK.bdof_blend_batch_cuda(p0, p1, bd, w, h).numpy(),
                                      RK.bdof_blend_batch_plain(p0, p1, bd, w, h).numpy())


@pytest.mark.parametrize("w,h", [(8, 8), (16, 16)])
def test_bdof_blend_unaligned(lib, w, h):
    """Predictions and output 4 bytes off a 16-byte boundary give the same
    result; a 4-wide sub-block is refused."""
    rng = np.random.default_rng(120 + w)
    n = _bdof_counts(w, h)[2]
    p0, p1 = (_misaligned(a) for a in T.bdof_case(rng, n, w, h, 10))
    out = _misaligned(np.full((n, h, w), -12345, dtype=np.int32))
    assert lib.vtm_bdof_blend(p0.data_ptr(), p1.data_ptr(), n, w, h, 10,
                              out.data_ptr(), None) == 0
    np.testing.assert_array_equal(out.numpy(),
                                  RK.bdof_blend_batch_plain(p0, p1, 10, w, h).numpy())
    assert lib.vtm_bdof_blend(p0.data_ptr(), p1.data_ptr(), n, 4, h, 10,
                              out.data_ptr(), None) != 0


def _transform_pairs():
    """Every (h, w, tr_hor, tr_ver) that transform._check_shape accepts."""
    kinds = (TR.DCT2, TR.DCT8, TR.DST7)
    pairs = []
    for h in (2, 4, 8, 16, 32, 64):
        for w in (2, 4, 8, 16, 32, 64):
            for tr_hor in kinds:
                for tr_ver in kinds:
                    try:
                        TR._check_shape(h, w, tr_hor, tr_ver)
                    except ValueError:
                        continue
                    pairs.append((h, w, tr_hor, tr_ver))
    return pairs


def _coeffs(rng, n: int, h: int, w: int) -> np.ndarray:
    """n int16-range blocks: seeded values, then blocks at the range's ends
    (-32768 and 32767 only)."""
    c = rng.integers(-32768, 32768, size=(n, h, w))
    ends = rng.choice(np.array([-32768, 32767]), size=(n, h, w))
    return np.where(np.arange(n)[:, None, None] % 2 == 1, ends, c).astype(np.int32)


@pytest.mark.parametrize("bd", [8, 10])
def test_inv_transform_every_shape(emu_launch, bd):
    """inv_transform_batch_cuda against the plain version on every block
    size and kind pair: three blocks each, which the square 8-64 shapes
    take to the register-tiled kernel (fewer blocks than a group, or at 64
    points three groups) and every other shape to the general kernel."""
    rng = np.random.default_rng(130 + bd)
    pairs = _transform_pairs()
    assert len(pairs) == 196
    for h, w, tr_hor, tr_ver in pairs:
        c = torch.from_numpy(_coeffs(rng, 3, h, w))
        np.testing.assert_array_equal(
            TR.inv_transform_batch_cuda(c, bd, tr_hor, tr_ver).numpy(),
            TR.inv_transform_batch_plain(c, bd, tr_hor, tr_ver).numpy())


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("n", [8, 16, 32, 64])
def test_inv_transform_tiles(lib, n, bd):
    """The register-tiled kernel through the C entry, into an output filled
    with a sentinel: block counts of a group less one, one group, a group
    and a part of the next, and three groups and one (the emulation keeps
    one CTA resident, so it walks every group), DCT2 and mixed DST7 / DCT8;
    then the same blocks 4 bytes off a 16-byte boundary, which the general
    kernel takes, with the same result."""
    rng = np.random.default_rng(140 + n + bd)
    group = 256 // (n // 4) ** 2  # 256 threads, a 4 x 4 tile each
    kinds = [(TR.DCT2, TR.DCT2)] + ([(TR.DST7, TR.DCT8)] if n <= 32 else [])
    for tr_hor, tr_ver in kinds:
        tv, th = TR._tmat(tr_ver, n, "cpu"), TR._tmat(tr_hor, n, "cpu")
        for b in sorted({max(group - 1, 1), group, group + group // 2 + 1, 3 * group + 1}):
            c = torch.from_numpy(_coeffs(rng, b, n, n))
            want = TR.inv_transform_batch_plain(c, bd, tr_hor, tr_ver).numpy()
            out = torch.full((b, n, n), -12345, dtype=torch.int32)
            assert lib.vtm_inv_transform(c.data_ptr(), out.data_ptr(), tv.data_ptr(),
                                         th.data_ptr(), b, n, n, bd, None) == 0
            np.testing.assert_array_equal(out.numpy(), want)
        c = _misaligned(_coeffs(rng, group + 1, n, n))
        out = _misaligned(np.full((group + 1, n, n), -12345, dtype=np.int32))
        assert lib.vtm_inv_transform(c.data_ptr(), out.data_ptr(), tv.data_ptr(),
                                     th.data_ptr(), group + 1, n, n, bd, None) == 0
        np.testing.assert_array_equal(
            out.numpy(), TR.inv_transform_batch_plain(c, bd, tr_hor, tr_ver).numpy())


def test_recon_sse(emu_launch):
    """The sharded reconstruction's epilogue against its plain version on
    three 32x32 blocks: clipped samples and the exact sum of squares."""
    rng = np.random.default_rng(150)
    shape = (3, 32, 32)
    resid = torch.from_numpy(rng.integers(-300, 300, size=shape).astype(np.int32))
    pred = torch.from_numpy(rng.integers(0, 256, size=shape).astype(np.int32))
    orig = torch.from_numpy(rng.integers(0, 256, size=shape).astype(np.int32))
    recon, sse = MS.recon_sse_cuda(resid, pred, orig)
    want_recon, want_sse = MS.recon_sse_plain(resid, pred, orig)
    np.testing.assert_array_equal(recon.numpy(), want_recon.numpy())
    assert int(sse[0]) == int(want_sse[0])
