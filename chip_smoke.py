#!/usr/bin/env python3
"""Smoke run of vtm_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card, nvcc and
PyTorch built for CUDA (no jax needed).  Phases, each fatal on failure:

1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
   no CUDA means exit 1 with no result;
2. build the CUDA kernels of vtm_tpu_torch/csrc from the checkout (nvcc,
   sm_90a, one process per source, in parallel), and print each compiled
   kernel's registers, stack frame, spill bytes and static shared bytes
   (ptxas -v; a template instantiation with its arguments), and the
   deblocking tile kernels' and the halo kernels' launch shape (resident
   blocks an SM); an RMD
   kernel that spills, or an MC, ALF-filter, ALF-classifier, luma
   deblocking tile, FIR, DMVR-search, BDOF, RMD-reduction, register-tiled
   inverse transform, SATD, SAO or halo kernel with a stack frame or
   spills, fails;
3. each kernel against its plain torch version, exactly:
   - the filter kernels on the real chain inputs of POC 0 of
     testdata/ai_full_hd1080_qp37.bit (1920x1080 4:2:0 8-bit, LMCS +
     deblock + SAO + ALF + CC-ALF), and at each smaller picture size the
     counted paths launch them at, on the pictures of one stream that
     together run every stage the stream runs: ai444_screen_qp32 (208x120
     4:2:0, SAO and ALF in every component), ai_full_bq416_qp27 (416x240
     4:2:0) and ai422_small208_qp32 (208x120 4:2:2); and on a
     numpy-seeded 10-bit 4:4:4 case;
   - the MC, DMVR-search, FIR and BDOF kernels on the inputs of every call
     of the port's own CUDA decode of testdata/ra_full_bq416_qp37.bit
     (416x240 RA, every inter tool on; the FIR group by group and as
     dmvr_final_pack's one launch; each DMVR and BDOF call's size beside
     its count) and of ra_full_small208_qp32 (208x120 RA), timed there as
     the decode launches them, and on numpy-seeded batches the size of a
     1080p 4:2:0 picture (the FIR also as a six-group dmvr_final_pack);
   - the MC kernel on the inputs of every MMVD and GEO preselection call of
     the port's RA encode of two 208x120 pictures on the card (one CU's
     candidates a call), timed as the encode launches them, a line a batch
     size (shape "encode");
   kernel and plain times from CUDA events: the
   kernel's device time (`ms`: a spin kernel queued ahead of the start
   event keeps the host's issue time out of the window; a row that cannot
   be timed so is printed as host-paced, with the reason) beside the time
   of the calls as the host issues them (`call_ms`), and its launches in
   each timed call;
   - the SATD kernel on numpy-seeded differences of every tiling (8- and
     10-bit extremes), 1920x1080 samples per call;
   - the three RMD kernels on every block-size class of a 1920x1080 picture
     mirror-tiled from testdata/bq416_416x240_420_8.yuv (MIP on, 888,628
     positions; per class: positions, operations, bound, kernel and plain
     ms, and each kernel's threads, shared bytes, resident blocks an SM,
     positions a block, registers and spills; the reduction beside its
     library call, torch.min over the angular and over the MIP columns,
     held equal first), timed the same way on frame 0 of small208 (208x120)
     and of bq416 (416x240), the sizes of the smaller encodes, and checked
     on numpy-seeded 10-bit 256x192 and 1920x1080 pictures;
   - the two inverse transforms (int32 MACs; int8 tensor cores) on batches
     the size of a 1920x1080 plane, every block size and kind pair, 8- and
     10-bit, each against the plain version and the two against each
     other (a line per square DCT2 size at 8 bits: both kernels' device
     ms, the int8 one's bound, the faster); the luma deblocking delta on the eight 240-column VER shards
     (with real halos) of the 1080p picture and on its eight HOR shards
     (the VER result transposed, edge-padded), and beside them the device
     time of an empty kernel, of a copy of one VER and one HOR shard's
     plane, and of a one-tile launch of the delta and of the classifier (a
     launch's floors); the classifier and the luma ALF filter on one
     248-column shard as the sharded chain pads it; the extended-plane SAO
     on the eight VER shards; the recon/SSE epilogue on two 1080p planes
     of 32x32 blocks; the two halo kernels (csrc/halo.cu) on the eight
     240-column VER shards, one launch for all: vtm_halo_gather with 8
     halo columns (deblocking), 1 with an edge row (SAO) and 4 with four
     (ALF), vtm_halo_add_deltas returning the VER deltas, and the gather as
     the ring of mesh.halo_exchange on the shards transposed, 8 rows a side
     (device ms beside its bytes bound: each shard read once, each
     extended shard written once, a halo strip being part of a
     neighbour's shard; the delta return reads its neighbours' edge
     deltas besides; the library column the torch.cat / edge_pad / slice
     calls they replace);
   - the multi-device path's MC and reconstruction kernels at the shapes
     its lanes launch them (phase 6's own inputs): vtm_mc_tiles on one
     lane's share of each sharded MC batch (the 1080p-sized seeded batch
     and the RA slice on 1 and 4 lanes, the ra_full_small208_qp32 batch on
     1, 2 and 8), vtm_inv_transform and vtm_recon_sse on one lane's slice
     of the (2, 2040, 32, 32) reconstruction step on 1 x 1 and 2 x 2 lanes
     (4,080 and 1,020 32x32 blocks);
   each row of the kernel JSON carries its bound: the larger of the bytes
   its timed calls must move (inputs read once, outputs written once; of
   MC's reference planes, the rows its tiles can reach) over
   the card's 3.35 TB/s and their operations over the peak rate of their
   type (int32: 132 SMs x 64 lanes x 1.98 GHz; int8 tensor cores: 1,979
   T/s);
4. the decode main path through vtm_tpu_torch.decoder.declib.Decoder(
   device="cuda"): the 1080p all-intra stream, three small all-intra streams
   (10-bit, 4:2:2, CC-ALF) and three inter streams (the flagship RA stream,
   LD-B with every tool, IBC), every picture hash checked; then every
   golden stream of testdata/ (48), each hash-exact (a stream whose
   pictures are not all hashed: equal to the YUV beside it), with its
   launches;
5. the encode main path through vtm_tpu_torch.encoder.enc_lib.IntraEncoder(
   device="cuda"): three 208x120 encodes (CC-ALF, MIP and SAO engaged),
   byte-identical to the same encodes with device="cpu", and one 1920x1080
   picture at QP 37 (bench.py's north-star configuration), each stream
   decoded hash-exact by the port's decoder; then the inter encode through
   RandomAccessEncoder(device="cuda") with RA's default tools, SAO and ALF:
   (a) five 208x120 pictures (small208x9, whose first three frames are
   small208's) at GOP 4, QP 32, byte-identical to the same encode with
   device="cpu"; (b) three 416x240 pictures (bq416, JVET CTC
   class D) at GOP 2, QP 37, under torch.profiler (CUDA activity), with
   s/picture split into the FrameRMD wait, deblocking, SAO and ALF, the
   MMVD and GEO preselection and the rest (host RD search, CABAC), the
   preselection's MC calls and their device time, and the device's idle
   share; both streams decoded hash-exact on the card; each inter encode
   must launch vtm_mc_tiles and the RMD kernels, and a deblocking, SAO or
   ALF kernel it leaves out must be one the decode of its stream leaves
   out too (the two encodes together launch them all); then the
   GOP-parallel encode through vtm_tpu_torch.parallel.gop.encode_parallel(
   device="cuda") with 2 spawned workers and with 1 (in-process): (c) two
   1080p pictures all-intra at QP 37, a segment each, and (d) four
   208x120 pictures RA (small208x9, GOP 2, QP 32, SAO; ALF off, because
   parcat keeps only the first segment's ALF APS), two segments of an I
   and a B picture; the two runs' streams identical and decoded
   hash-exact on the card, s/picture of both and their ratio beside the
   host's cores and torch's threads; the workers return their launch
   counts with their streams, and each run must launch the RMD and
   deblocking kernels, (d) also vtm_mc_tiles;
6. the multi-device main path on lanes that share the one card
   (vtm_tpu_torch.parallel): dryrun_multichip on both pictures of the 1080p
   stream at gop 2 x tile 2 and at tile 8 (240 columns a lane), and on
   ra_full_small208_qp32 at n = 2 and 8 (the reference's own case); the MC
   job axis split over 4 lanes on a 1080p-sized seeded batch and on a slice
   batch of the flagship RA stream; sharded_recon_step at F = 2, T = 2040,
   N = 32 on 4 lanes; every lane equal to its picture's single-lane result
   (MC and recon: to the plain version's), and each sharded stage run 7
   times, its host seconds (median, min, max) beside its one-lane run's;
   the decodes that capture its inputs run before its counts are zeroed,
   and its launches are those of one run of each stage (every run must
   launch what the first did); then the live decode mesh:
   Decoder(device="cuda") under decode_mesh_ctx(codec_mesh(4, gop=2))
   (2 x 2 lanes sharing the card; every MC batch split over the four
   lanes, the luma chain width-sharded over 'tile', the chroma on the home
   lane) on ld_min_tiny64_qp32, ai_min_tiny64_qp27, ai_full_tiny64_qp32,
   ra_full_bq416_qp37 (208-column shards), ai_full_hd1080_qp37 (960) and
   ai_ccalf_cc208_qp32 (104, CC-ALF), each decoded once: every picture hash-exact and equal to phase 4's
   mesh-off decode, s/picture beside mesh-off, each picture's route, and
   the MC, luma filter and halo kernels launched; every sharded call it
   made (recorded) is then held to its plain version and timed at its own
   shape;
   launch counts, zeroed before each main path and read after it, prove
   that the three paths ran through every kernel (two excepted, checked and
   timed in phase 3 only: the standalone SATD entry point, whose code runs
   inside the RMD kernels, and the int8 transform, which the reference
   calls from its tests alone); the encodes' own
   counts, without the decodes that check their streams, prove that the
   encoder's RMD, deblocking, SAO and ALF, and the inter encodes' MC, ran
   through the kernels;
7. each kernel's bound line (device and call ms; the library call's ms
   where one was timed), the launches at each shape, and the redesign
   order (each kernel's launches x (device ms - bound ms) per launch of
   its timed calls at the shape the launches run at, a part a shape: for
   the decode and encode paths and the multi-device path's gop-batched
   chain, whose lanes take whole pictures, the picture's size and chroma
   format, as "picture 208x120 420", each stream's, encode's and GOP
   case's launches taken from count deltas around it and held to add up
   to its phase's counts: the filter kernels' at phase 3's chain pictures
   of that size, the RMD kernels' at the classes of a source of that size,
   the inter kernels' at the recorded calls of the RA decode of that size;
   "encode" for the inter encodes' own MC launches, at phase 3's recorded
   preselection calls; "shard" for the sharded luma chain, MC and
   reconstruction, each shard case weighed as often as one run launches
   it; "live shard WxH" and "live MC lane share <stream>" for the live
   mesh's sharded launches, at their recorded calls; a kernel with
   launches at a shape where none of its cases was timed fails),
   the extended-plane SAO's shard launches beside an empty kernel, a copy
   of a shard's plane and the vtm_halo_gather launch that extends every
   shard ahead of them, one JSON line of per-kernel results, then the
   device line, last.

    python3 chip_smoke.py --versus DIR

instead times this checkout's kernels against another commit's build of
the same sources, in one process on one card, in turns (other, this, this,
other), in device ms, each result equal to this checkout's.  DIR holds
that commit's sources (e.g. from `git show c51c14f:vtm_tpu_torch/csrc/
deblock.cu`), built into DIR/libversus_*.so with the entry points renamed:
rmd.cu, satd.cuh and common.cuh time the three RMD kernels class by class
on the 1080p source; deblock.cu (165e438 or later) and common.cuh time the
luma and chroma
deblocking on POC 0 of the 1080p stream, VER and HOR, and the luma delta
on its eight VER and eight HOR shards; mc.cu, fir.cuh and common.cuh time
the MC tiles on phase 3's 1080p-sized seeded batches; alf.cu and
common.cuh time the classifier on POC 0's luma and the ALF filter on its
Y, Cb and Cr;
refine.cu, fir.cuh and common.cuh time the FIR on phase 3's 1080p-sized
luma blocks and six-group dmvr_final_pack call, and the DMVR search and
the BDOF blend on every call of the RA decode (recorded from this
checkout's decode, a row a call) and on 8,100 seeded 16x16 sub-PUs and
sub-blocks; transform.cu and
common.cuh (with tc.cuh where the commit has one) time the int32 inverse
transform on the sharded reconstruction's 4,080- and 1,020-block lane
slices of 32x32 DCT2 blocks and on 1080p-plane batches of the DCT2 sizes
8 to 64, and the int8 one on 1080p-plane batches of the DCT2 sizes 2 to 64
(each size also against this checkout's int32 kernel) and of 4x16 DST7 /
DCT8 and 64x2 DCT2 blocks; rdcost.cu, satd.cuh
and common.cuh time the SATD on phase 3's 13 tilings at 8 bits (1920x1080
samples each); sao.cu and common.cuh time the extended-plane SAO on the
eight VER shards of each picture of the 1080p stream with luma SAO and of
POC 0's luma with seeded maps (half the CTUs on), and the plane SAO on
POC 0's Y, Cb and Cr (a plane without SAO in that picture with seeded
maps); halo.cu and common.cuh time the two halo kernels on phase 3's cases
(the eight VER shards of 1080p POC 0 at h 8, h 1 pad 1 and h 4 pad 4, the
VER deltas' return, the ring) and on every halo call of the live decode
mesh (recorded), both builds given the same lane tables, then this
checkout's halo.cu built with every launch forced to its row kernels and
to its element kernels, on seeded shards of growing size (`halo
crossover` lines).
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from functools import partial

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
    "vtm_halo_gather": ("vtm_tpu_torch/csrc/halo.cu",
                        "vtm_tpu/parallel/mesh.py:35"),
    "vtm_halo_add_deltas": ("vtm_tpu_torch/csrc/halo.cu",
                            "vtm_tpu/parallel/pic_shard.py:89"),
}
# the shape of the inter kernels' numpy-seeded 1080p-sized batches: timed for
# their rows; no main path launches them at that shape (the decode path's
# inter launches are weighed at its recorded RA calls)
SEEDED = "1080p seeded"
# peak rates of one H100 SXM at 700 W: memory, int32 lanes, int8 tensor cores
BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
INT8_TC_OPS_PER_S = 1979e12
# kernels of the multi-device main path (phase 6)
MESH_KERNELS = ("vtm_inv_transform", "vtm_recon_sse",
                "vtm_deblock_luma_ver_delta", "vtm_sao_apply_ext",
                "vtm_alf_classify", "vtm_alf_filter", "vtm_mc_tiles",
                "vtm_deblock_luma_ver", "vtm_deblock_chroma_ver", "vtm_sao_apply",
                "vtm_halo_gather", "vtm_halo_add_deltas")
# the streams of phase 6's live decode mesh (Decoder under decode_mesh_ctx on
# 2 x 2 lanes sharing the card): the reference's three 64x64 ones, the
# flagship RA stream (208-column shards), the 1080p stream at full width
# (960-column shards, LMCS; its chain runs no CC-ALF) and a 208x120 stream
# whose chain runs CC-ALF (104-column shards; the luma after SAO goes back to
# the home lane for it)
LIVE_STREAMS = ("ld_min_tiny64_qp32", "ai_min_tiny64_qp27", "ai_full_tiny64_qp32",
                RA_STREAM, HD_STREAM, "ai_ccalf_cc208_qp32")
# kernels the live decode mesh must launch
LIVE_KERNELS = ("vtm_mc_tiles", "vtm_deblock_luma_ver_delta", "vtm_sao_apply_ext",
                "vtm_alf_classify", "vtm_alf_filter", "vtm_halo_gather",
                "vtm_halo_add_deltas")
# kernel -> ptxas counts that must be 0 (phase 2): the redesigned kernels keep
# every value in registers or shared memory
NO_LOCAL_MEMORY = {
    **dict.fromkeys(("rmd_angular_kernel", "rmd_mip_kernel"),
                    ("spill_stores", "spill_loads")),
    **dict.fromkeys(("mc_tiles_kernel", "alf_filter_kernel", "fir_blocks_kernel",
                     "rmd_reduce_kernel", "alf_classify_kernel", "luma_tile_kernel",
                     "inv_transform_tile_kernel", "dmvr_search_kernel",
                     "bdof_blend_kernel", "satd_batch_kernel", "sao_kernel",
                     "inv_transform_s8_kernel", "halo_gather_kernel",
                     "halo_add_deltas_kernel", "halo_gather_elem_kernel",
                     "halo_add_deltas_elem_kernel"),
                    ("spill_stores", "spill_loads", "stack_frame"))}
HALO_ENTRIES = ("vtm_halo_gather", "vtm_halo_add_deltas")
HALO_KERNELS = ("halo_gather_kernel", "halo_add_deltas_kernel", "halo_gather_elem_kernel",
                "halo_add_deltas_elem_kernel")
# runs of each sharded stage whose host seconds are compared (median)
REPEATS = 7
TRANSFORM_KINDS = ((0, 0), (2, 1), (1, 2), (2, 2), (1, 1))
# kernels checked and timed in phase 3 that no main path launches by name
NOT_ON_MAIN_PATH = {"vtm_satd_batch": "its tile transform runs fused inside "
                                      "vtm_rmd_angular and vtm_rmd_mip "
                                      "(csrc/satd.cuh:warp_satd_tile)",
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
# the inter encodes of phase 5, random access with RA's default tools, SAO and
# ALF, as (source, width, height, frames, GOP size, QP): (a) on the card and on
# the CPU, byte for byte (small208 has three frames; small208x9 continues
# them); (b) at JVET CTC class D's size (the RA golden
# stream's), I then POC 2 then POC 1, its stream decoded on the card.  A
# 1080p inter picture would take the host's RD search many minutes.
RA_ENC_SMALL = ("small208x9_208x120_420_8", 208, 120, 5, 4, 32)
RA_ENC_D = ("bq416_416x240_420_8", 416, 240, 3, 2, 37)
# the encode whose preselection MC calls phase 3 records and times: I, then
# one B picture on POC 0
RA_ENC_CAPTURE = ("small208_208x120_420_8", 208, 120, 2, 2, 32)
# the shape of the inter encode's MC launches: one CU's MMVD or GEO candidates
ENCODE = "encode"
# the streams whose chain inputs phase 3 times the filter kernels on, one for
# each picture size below 1080p that the counted paths launch them at (the
# first has SAO and ALF in every component; none of the 208x120 4:2:0
# streams the paths decode has SAO); 1080p is POC 0 of HD_STREAM
FILTER_SIZE_STREAMS = ("ai444_screen_qp32", "ai_full_bq416_qp27", "ai422_small208_qp32")
# the stream whose MC, DMVR, FIR and BDOF calls phase 3 records and times at
# 208x120 (RA_STREAM's are the 416x240 ones)
INTER_SMALL_STREAM = "ra_full_small208_qp32"
# the sources whose frame 0 phase 3 times the RMD kernels on below 1080p, as
# (source, width, height): every MIP launch is small208's (ENC_CASES), the
# 416x240 ones RA (b)'s I picture
RMD_SIZE_SOURCES = (("small208_208x120_420_8", 208, 120),
                    ("bq416_416x240_420_8", 416, 240))
# the GOP-parallel encodes of phase 5 (vtm_tpu_torch.parallel.gop), each run
# with 2 workers and then 1: (c) two 1080p pictures all-intra with bench.py's
# north-star configuration, a segment each; (d) four 208x120 pictures RA,
# two segments of an I and a B picture, SAO on and ALF off: parcat drops the
# ALF APS of every segment after the first, as the reference's does
# (apps/parcat.py), so a stitched stream with ALF decodes its later
# segments with the first one's filters
GOP_CASES = (
    ("(c)", "intra", "hd_source", dict(width=1920, height=1080, qp=37), 2, 1, None,
     ("vtm_rmd_angular", "vtm_rmd_reduce", "vtm_deblock_luma_ver",
      "vtm_deblock_chroma_ver")),
    ("(d)", "ra", "small208x9_208x120_420_8",
     dict(width=208, height=120, qp=32, sao=True), 4, 2, dict(gop_size=2),
     ("vtm_mc_tiles", "vtm_rmd_angular", "vtm_rmd_reduce", "vtm_deblock_luma_ver",
      "vtm_deblock_chroma_ver")))
INTER_ENC_KERNELS = ("vtm_mc_tiles", "vtm_rmd_angular", "vtm_rmd_reduce",
                     "vtm_deblock_luma_ver", "vtm_deblock_chroma_ver", "vtm_sao_apply",
                     "vtm_alf_classify", "vtm_alf_filter")
# decode kernels the encoder does not launch: only the decodes of its streams
NOT_IN_ENCODER = {"vtm_ccalf_filter": "the encoder applies CC-ALF on the host "
                                      "(vtm_tpu_torch/encoder/alf_search.py:"
                                      "derive_ccalf, called from "
                                      "encoder/enc_lib.py)"}


def size_key(w: int, h: int, fmt: str) -> str:
    """The shape phase 7 weighs a launch on a whole picture at: its luma
    size and chroma format, as `picture 1920x1080 420`."""
    return f"picture {w}x{h} {fmt}"


def planes_key(planes) -> str:
    """size_key of a picture's planes (Y, or Y, Cb, Cr)."""
    h, w = planes[0].shape
    if len(planes) == 1:
        return size_key(w, h, "400")
    hc, wc = planes[1].shape
    return size_key(w, h, {(2, 2): "420", (1, 2): "422", (1, 1): "444"}[(h // hc, w // wc)])


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def demangle(sym: str) -> str:
    """An Itanium-mangled kernel name with int or bool template arguments,
    as `name<4, 8>` or `name<true>` (enough for this repo's kernels)."""
    m = re.match(r"_Z(\d+)(\w+)", sym)
    if not m:
        return sym
    n, rest = int(m.group(1)), m.group(2)
    name, tail = rest[:n], rest[n:]
    args = re.match(r"I((?:L[ib]\d+E)+)E", tail)
    if args:
        vals = [v if t == "i" else ("true" if v == "1" else "false")
                for t, v in re.findall(r"L([ib])(\d+)E", args.group(1))]
        name += "<" + ", ".join(vals) + ">"
    return name


def ptxas_report(diag: str) -> dict:
    """{kernel: {registers, smem_bytes, stack_frame, spill_stores,
    spill_loads}} from nvcc -Xptxas -v."""
    rows, prop, entry = {}, None, None
    for line in diag.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = demangle(m.group(1))
            rows[entry] = {}
            continue
        m = re.search(r"Function properties for (\w+)", line)
        if m:
            prop = demangle(m.group(1))
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and prop in rows:
            rows[prop].update(stack_frame=int(m.group(1)), spill_stores=int(m.group(2)),
                              spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry in rows:
            rows[entry]["registers"] = int(m.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            rows[entry]["smem_bytes"] = int(smem.group(1)) if smem else 0
    return rows


def cuda_ms(torch, fn, iters: int = 10) -> float:
    """Mean time of fn() in ms between CUDA events around `iters` calls,
    after up to two warm-up calls.  Host-paced: where the host takes longer
    to issue a call than the card to run it, this is the host's time."""
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


_SPIN = {}


def spin_cycles_per_s(torch) -> float:
    """Clock cycles a second of the spin kernel (torch.cuda._sleep), from
    CUDA events around a 20 M-cycle spin (measured once a process)."""
    if "rate" not in _SPIN:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1000)
        start.record()
        torch.cuda._sleep(20_000_000)
        end.record()
        torch.cuda.synchronize()
        _SPIN["rate"] = 20_000_000 / (start.elapsed_time(end) / 1e3)
    return _SPIN["rate"]


def device_ms(torch, fn, iters: int = 10) -> tuple[float, str | None]:
    """Mean device time of fn() in ms, the host's issue time kept outside
    the window: a spin kernel queued ahead of the start event holds the card
    until the host has issued all `iters` calls, so the events bracket the
    calls' device work back to back (warm-up as in cuda_ms).  The spin is
    sized from the issue loop's host time (at least 4x it, and 1 ms), and
    checked: the start event must still be pending once the calls are
    issued.  Else a second try with a spin 8x longer; if that fails too,
    returns the events' time with the reason the row is host-paced (the
    wrapper waits on the card, or its issue loop outlasted the spin)."""
    for _ in range(min(2, iters)):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    bare = time.perf_counter() - t0
    torch.cuda.synchronize()
    rate = spin_cycles_per_s(torch)
    spin = max(4 * bare, 1e-3)
    for _ in range(2):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(spin * rate))
        start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        end.record()
        issued = time.perf_counter() - t0
        covered = not start.query()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / iters
        if covered:
            return ms, None
        spin *= 8
    why = ("the wrapper waits on the card" if bare < spin / 16
           else "its issue loop outlasted the spin")
    return ms, (f"host-paced: {why} (issue loop {issued * 1e3:.3f} ms, alone "
                f"{bare * 1e3:.3f} ms, spin {spin / 8 * 1e3:.3f} ms)")


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


class Bytes(int):
    """A byte count that nbytes adds as it stands: the part of an input that
    a kernel can read, where that is less than the whole tensor."""


def nbytes(*trees) -> int:
    """Bytes of the distinct tensors in nested tuples / lists (each counted
    once, however often it appears), plus every Bytes among them."""
    seen, total = set(), 0

    def walk(x):
        nonlocal total
        if isinstance(x, (tuple, list)):
            for y in x:
                walk(y)
        elif isinstance(x, Bytes):
            total += x
        elif hasattr(x, "data_ptr") and x.data_ptr() not in seen:
            seen.add(x.data_ptr())
            total += x.numel() * x.element_size()

    walk(trees)
    return total


class KernelCheck:
    """Per-kernel results: largest deviation from the plain version, the
    times (device-only `ms`, host-paced `call_ms`, the plain version's), the
    kernel's launches inside the timed calls, and the bytes and operations
    of the work, summed over the cases that time the kernel."""

    def __init__(self, torch):
        self.torch = torch
        self.last = None  # the last timed comparison: ms, call_ms, plain_ms, bytes, ops
        self.rows = {k: dict(max_abs_err=0, ms=0.0, call_ms=0.0, plain_ms=0.0,
                             library_ms=None, bytes=0, ops=0.0, peak=INT32_OPS_PER_S,
                             timed=0, launches=0, paced=[], shapes={}, cases=[])
                     for k in KERNEL_INFO}
        self.floors = {}  # launch_floor's readings by label

    def compare(self, kernel: str, label: str, cuda_fn, plain_fn,
                timed: bool = False, iters: int = 10, ins=(), ops: float = 0,
                peak: float = INT32_OPS_PER_S, quiet: bool = False, library=None,
                shape: str | None = None, weight: int = 1):
        """Kernel against plain version; with `timed`, both timed, and the
        bound counted: the bytes of `ins` and of the result, and `ops`
        operations at `peak` per second, also per `shape` (a size_key: a
        whole picture of that size and chroma format, at which the decode
        and encode paths and the multi-device path's gop-batched chain
        launch the kernel; "shard": a lane's share of a picture or a batch
        on the multi-device path; ENCODE: the inter encode's preselection
        calls; SEEDED: the inter kernels' 1080p-sized batches, which no
        path launches; None: a case no path launches at, kept out of the
        per-shape sums), there `weight` times: the launches of one run of
        the path that this case stands for.
        `library`: (fn, agree) of PyTorch calls that compute the same
        function, never used by the port: with `timed`, fn() is held to the
        kernel's result (agree(got, fn()) must be true) and then timed as
        the row's library_ms.  `quiet` prints nothing unless the two
        disagree."""
        from vtm_tpu_torch import kernels as KN

        torch = self.torch
        before = KN.launch_counts()[kernel]
        got = cuda_fn()
        per_call = KN.launch_counts()[kernel] - before
        want = plain_fn()
        torch.cuda.synchronize()
        err = max_err(torch, got, want)
        row = self.rows[kernel]
        row["max_abs_err"] = max(row["max_abs_err"], err)
        msg = f"{kernel} [{label}]: max |kernel - plain| = {err}"
        if timed:
            ms, paced = device_ms(torch, cuda_fn, iters)
            call = cuda_ms(torch, cuda_fn, iters)
            if paced:  # no device-only time: the row keeps the call's
                ms = call
            pms = cuda_ms(torch, plain_fn, iters)
            row["ms"] += ms
            row["call_ms"] += call
            row["plain_ms"] += pms
            row["bytes"] += nbytes(ins, got)
            row["ops"] += ops
            row["peak"] = peak
            row["timed"] += 1
            row["launches"] += per_call
            if shape is not None:
                by = row["shapes"].setdefault(shape, [0.0, 0, 0.0, 0])  # ms, bytes, ops, launches
                for k, v in enumerate((ms, nbytes(ins, got), ops, per_call)):
                    by[k] += weight * v
            if paced:
                row["paced"].append(f"{label}: {paced}")
            self.last = dict(ms=ms, call_ms=call, plain_ms=pms,
                             bytes=nbytes(ins, got), ops=ops)
            row["cases"].append((label, ms, max(nbytes(ins, got) / BYTES_PER_S,
                                                ops / peak) * 1e3))
            msg += (f", {per_call} launches a call, kernel "
                    f"{ms:.6f} ms ({paced + '; the call time' if paced else 'device'}), "
                    f"{call:.6f} ms (call), plain {pms:.6f} ms")
            if library is not None:
                lib_fn, agree = library
                if not agree(got, lib_fn()):
                    raise AssertionError(f"{kernel} [{label}]: the library call "
                                         "disagrees with the kernel")
                lms, lpaced = device_ms(torch, lib_fn, iters)
                if lpaced:
                    raise AssertionError(f"{kernel} [{label}] library call {lpaced}")
                row["library_ms"] = (row["library_ms"] or 0.0) + lms
                msg += f", library {lms:.6f} ms (device; equal to the kernel's result)"
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

    def per_launch(self, kernel: str, shape: str) -> tuple[float, float]:
        """(device ms, bound ms) per launch of the timed calls at `shape`,
        each case counted `weight` times; raises where none was timed
        there."""
        row = self.rows[kernel]
        if shape not in row["shapes"]:
            raise AssertionError(f"{kernel} has main-path launches at {shape} "
                                 "but no timed case there")
        ms, nb, ops, n = row["shapes"][shape]
        bound = max(nb / BYTES_PER_S, ops / row["peak"]) * 1e3
        return ms / n, bound / n


def check_kernels(torch, chk: KernelCheck, y, cb, cr, lut, dbv, dbh, sao, alf,
                  bd, sx, sy, fl, label: str, timed: bool, shape: str | None = None):
    """Every kernel against its plain version on one picture's chain
    inputs, stage by stage (each stage's input is the previous stage's
    output); timed at `shape` (the picture's size_key) where `timed`."""
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
                ins=(y, maps[0:7]), ops=10 * y.numel(), shape=shape)
        if hcb or hcr:
            ck = dict(kw, has_l=False, has_cb=hcb, has_cr=hcr)
            # Cb and Cr only: the luma plane passes through unchanged
            cb, cr = chk.compare(
                "vtm_deblock_chroma_ver", tag,
                lambda: DK.deblock_dir_cuda(y, cb, cr, *maps, **ck)[1:],
                lambda: DK.deblock_dir_plain(y, cb, cr, *maps, **ck)[1:], timed,
                ins=(cb, cr, maps[7:17]), ops=10 * (cb.numel() + cr.numel()), shape=shape)
    planes = [y, cb, cr]
    for comp, on in enumerate((s0, s1, s2)):
        if on:
            p, m = planes[comp], sao[comp]
            planes[comp] = chk.compare(
                "vtm_sao_apply", f"{label} comp {comp}",
                lambda: SK.sao_apply_cuda(p, *m, bit_depth=bd),
                lambda: SK.sao_apply_plain(p, *m, bit_depth=bd), timed,
                ins=(p, m), ops=8 * p.numel(), shape=shape)
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
            ins=(y_pad, rows), ops=12 * y.numel(), shape=shape)
        gather = (ctu_of.long(), cls.long(), tr.long())
        coef, clip = cperm[gather], lperm[gather]
        chk.compare(
            "vtm_alf_filter", f"{label} luma",
            lambda: AK.alf_filter_cuda(y_pad, coef, clip, l_orows, l_near,
                                       taps=AK.LUMA_TAPS, bit_depth=bd),
            lambda: AK.alf_filter_plain(y_pad, coef, clip, l_orows, l_near,
                                        taps=AK.LUMA_TAPS, bit_depth=bd), timed,
            ins=(y_pad, coef, clip, l_orows, l_near), ops=48 * y.numel(),
            shape=shape)
    for on, c, co, cl in ((a_cb, cb, cb_coef, cb_clip), (a_cr, cr, cr_coef, cr_clip)):
        if on:
            c_pad = edge_pad(c, AK.PAD, AK.PAD)
            chk.compare(
                "vtm_alf_filter", f"{label} chroma",
                lambda: AK.alf_filter_cuda(c_pad, co, cl, c_orows, c_near,
                                           taps=AK.CHROMA_TAPS, bit_depth=bd),
                lambda: AK.alf_filter_plain(c_pad, co, cl, c_orows, c_near,
                                            taps=AK.CHROMA_TAPS, bit_depth=bd),
                timed, ins=(c_pad, co, cl, c_orows, c_near), ops=24 * c.numel(),
                shape=shape)
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
            timed, ins=(y_pad, c, cc, cc_orows, cc_skip), ops=14 * c.numel(),
            shape=shape)
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


def chain_flags(pic: dict) -> tuple:
    """The chain's stage flags of a captured picture (filter_chain.chain_flags)."""
    from vtm_tpu_torch.ops import filter_chain as FC

    return FC.chain_flags(len(pic["planes"]), pic["lmcs_lut"], pic["dmaps"],
                          pic["sao_maps"], pic["alf_tables"])


def covering_pictures(pics) -> list:
    """Indices of captured pictures that together run every chain stage
    that any picture of their stream runs (deblocking, SAO and ALF, each
    direction and component): greedily, the picture that adds the most
    stages first."""
    stages = [{i for i, on in enumerate(chain_flags(p)[1:13]) if on} for p in pics]
    want, got, chosen = set().union(*stages), set(), []
    while got != want:
        i = max(range(len(pics)), key=lambda j: len(stages[j] - got))
        chosen.append(i)
        got |= stages[i]
    return chosen


def time_chain_picture(torch, chk: KernelCheck, pic: dict, dev, label: str) -> str:
    """check_kernels on one captured picture's chain inputs, timed at its
    size_key, which it returns."""
    from vtm_tpu_torch.ops import filter_chain as FC

    planes, lmcs_lut, dmaps, sao_maps, alf_tables, bd, sx, sy = (pic[k] for k in (
        "planes", "lmcs_lut", "dmaps", "sao_maps", "alf_tables", "bd", "sx", "sy"))
    key, fl = planes_key(planes), chain_flags(pic)
    print(f"{label} ({key}) chain flags {fl}", flush=True)
    y, cb, cr = (FC.to_device(p, dev) for p in planes)
    dbv, dbh, sao, alf = FC.maps_to_torch(dmaps, sao_maps, alf_tables, dev)
    lut = FC.to_device(lmcs_lut, dev) if lmcs_lut is not None else None
    check_kernels(torch, chk, y, cb, cr, lut, dbv, dbh, sao, alf, bd, sx, sy,
                  fl, label, timed=True, shape=key)
    return key


def check_filter_sizes(torch, chk: KernelCheck, dev) -> None:
    """The filter kernels timed at each picture size below 1080p that the
    counted paths launch them at: on the pictures of each stream of
    FILTER_SIZE_STREAMS that together run every stage the stream runs
    (covering_pictures), each at its size_key."""
    from vtm_tpu_torch.parallel import multichip as MCH

    for stream in FILTER_SIZE_STREAMS:
        pics = MCH.capture_decode(stream, "cuda")["pics"]
        for i in covering_pictures(pics):
            time_chain_picture(torch, chk, pics[i], dev, f"{stream} chain picture {i}")


def capture_inter_inputs(MK, RK, Decoder, stream: str = RA_STREAM):
    """Arguments of every MC, DMVR-search, final-pack and BDOF call of the
    port's own CUDA decode of `stream` (the flagship RA stream by default;
    device tensors; the wrappers never write their inputs), and the size_key
    of its pictures."""
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
        pics = dec.decode_stream(read_stream(stream))
    finally:
        for key, (mod, name) in patches.items():
            setattr(mod, name, reals[key])
    if not dec.hash_results or not all(hr.ok for hr in dec.hash_results):
        raise AssertionError(f"{stream}: hash mismatch while recording")
    empty = [k for k, v in got.items() if not v]
    if empty:
        raise AssertionError(f"{stream}: no {empty} call recorded")
    return got, planes_key(pics[0].planes)


def mc_ops(n: int, taps: int, tile: int) -> int:
    """Multiply-adds of n MC tiles: the separable FIR's (tile + taps - 1) x
    tile + tile x tile taps a tile."""
    return n * ((tile + taps - 1) * tile + tile * tile) * taps


def dmvr_ops(n: int, dx: int, dy: int) -> int:
    """Operations of n DMVR searches: 25 offsets, a SAD over the even rows of
    a dx x dy sub-PU (3 ops a sample)."""
    return n * 25 * (dx * dy // 2) * 3


def bdof_ops(n: int, w: int, h: int) -> int:
    """Operations of n w x h BDOF sub-blocks, 30 a sample."""
    return n * w * h * 30


def mc_ref_bytes(planes, jobs, taps: int, tile: int) -> Bytes:
    """Bytes of the reference rows an MC batch can read: on each plane, the
    whole rows that its tiles' windows reach (clamped to the plane, as the
    kernel clamps), and no other (a lane's share of a batch in raster order
    reads a band of each plane)."""
    import torch

    r_idx, y0 = jobs[0], jobs[2]
    h = planes[0].shape[0]
    rows = (y0[:, None].long() + torch.arange(tile + taps - 1, device=y0.device)).clamp(0, h - 1)
    plane = r_idx.long().clamp(0, len(planes) - 1)[:, None].expand_as(rows)
    reached = torch.zeros((len(planes), h), dtype=torch.bool, device=y0.device)
    reached[plane, rows] = True
    return Bytes(int(reached.sum()) * planes[0].shape[1] * planes[0].element_size())


def check_inter_recorded(chk: KernelCheck, got, MK, RK, label: str, shape: str):
    """The four inter kernels against their plain versions on the recorded
    inputs of the decode of stream `label`, timed: these are the decode
    path's own calls at pictures of that size (`shape`, the stream's
    size_key), one case a launch.  The FIR is timed as the decode launches
    it, dmvr_final_pack's one launch a call, and checked group by group
    too."""
    for (largs, cargs, bd), _ in got["mc"]:
        for args, lum in ((largs, True), (cargs, False)):
            if args is None:
                continue
            taps, tile = MK.SHAPES[lum]
            kw = dict(taps=taps, tile=tile, bd=bd)
            planes, jobs, n = args[0], args[1:], args[1].shape[0]
            chk.compare("vtm_mc_tiles", f"{label} {'luma' if lum else 'chroma'}, {n} tiles",
                        lambda: MK.mc_tiles_cuda(*args, **kw),
                        lambda: MK.mc_tiles_plain(*args, **kw), timed=True, shape=shape,
                        ins=(mc_ref_bytes(planes, jobs, taps, tile), jobs),
                        ops=mc_ops(n, taps, tile))
    for args, kw in got["search"]:
        n = args[0].shape[0]
        chk.compare("vtm_dmvr_search", f"{label}, {n} {kw['dx']}x{kw['dy']} sub-PUs",
                    lambda: RK.dmvr_search_cuda(*args, **kw),
                    lambda: RK.dmvr_search_plain(*args, **kw), timed=True, shape=shape,
                    ins=args, ops=dmvr_ops(n, kw["dx"], kw["dy"]))
    for (l0, l1, cargs), kw in got["pack"]:
        jobs = pack_jobs(l0, l1, cargs, **kw)
        for a, fk in jobs:
            chk.compare("vtm_fir_blocks",
                        f"{label}, {a[0].shape[0]} {fk['w']}x{fk['h']} blocks",
                        lambda: RK.fir_blocks_cuda(*a, **fk),
                        lambda: RK.fir_blocks_plain(*a, **fk))
        chk.compare("vtm_fir_blocks", f"{label}, dmvr_final_pack of {len(jobs)} groups",
                    lambda: RK.dmvr_final_pack(l0, l1, cargs, **kw),
                    lambda: pack_plain(RK, jobs), timed=True, shape=shape,
                    ins=(l0, l1, cargs), ops=fir_ops(jobs))
    for args, kw in got["bdof"]:
        n = args[0].shape[0]
        chk.compare("vtm_bdof_blend", f"{label}, {n} {kw['w']}x{kw['h']} sub-blocks",
                    lambda: RK.bdof_blend_batch_cuda(*args, **kw),
                    lambda: RK.bdof_blend_batch_plain(*args, **kw), timed=True, shape=shape,
                    ins=args, ops=bdof_ops(n, kw["w"], kw["h"]))


def ra_encoder(case, device: str):
    """The port's RandomAccessEncoder for an RA_ENC_* case, on `device`, with
    a config of its own (the encoder switches RA's tools on in it)."""
    from vtm_tpu_torch.encoder.enc_lib import EncoderConfig, RandomAccessEncoder

    _, w, h, _, gop, qp = case
    cfg = EncoderConfig(width=w, height=h, qp=qp, sao=True, alf=True)
    return RandomAccessEncoder(cfg, gop_size=gop, device=device)


def ra_frames(case) -> list:
    from vtm_tpu_torch import testing as T

    src, w, h, n, _, _ = case
    return [T.read_source(src, w, h, i) for i in range(n)]


def capture_encode_mc(MK):
    """Arguments of every MC call of the port's RA encode of RA_ENC_CAPTURE on
    the card: the MMVD and GEO preselection batches, one CU's candidates a
    call (device tensors; the wrapper never writes its inputs)."""
    real = MK.mc_tiles_pair
    got = []

    def record(*args, **kw):
        got.append((args, kw))
        return real(*args, **kw)

    MK.mc_tiles_pair = record
    try:
        ra_encoder(RA_ENC_CAPTURE, "cuda").encode(ra_frames(RA_ENC_CAPTURE))
    finally:
        MK.mc_tiles_pair = real
    if not got:
        raise AssertionError(f"{RA_ENC_CAPTURE[0]}: no preselection MC call recorded")
    return got


def check_encode_recorded(chk: KernelCheck, got, MK):
    """vtm_mc_tiles against its plain version on every recorded preselection
    call of the RA encode, timed: the encode path's own shape (ENCODE), one
    case a launch.  One line a batch size: its calls, and the kernel's device
    ms and the plain version's a call."""
    label = f"{RA_ENC_CAPTURE[0]} RA encode preselection"
    sizes = {}
    for (largs, cargs, bd), _ in got:
        for args, lum in ((largs, True), (cargs, False)):
            if args is None:
                continue
            taps, tile = MK.SHAPES[lum]
            kw = dict(taps=taps, tile=tile, bd=bd)
            planes, jobs, n = args[0], args[1:], args[1].shape[0]
            chk.compare("vtm_mc_tiles", f"{label}, {n} tiles",
                        lambda: MK.mc_tiles_cuda(*args, **kw),
                        lambda: MK.mc_tiles_plain(*args, **kw), timed=True,
                        ins=(mc_ref_bytes(planes, jobs, taps, tile), jobs),
                        ops=mc_ops(n, taps, tile), quiet=True, shape=ENCODE)
            size = sizes.setdefault((lum, n), [0, 0.0, 0.0])
            size[0] += 1
            size[1] += chk.last["ms"]
            size[2] += chk.last["plain_ms"]
    for (lum, n), (calls, ms, pms) in sorted(sizes.items()):
        print(f"vtm_mc_tiles [{label}, {n} {'luma' if lum else 'chroma'} tiles a call]: "
              f"{calls} calls, max |kernel - plain| = 0, kernel {ms / calls:.6f} ms "
              f"a call (device), plain {pms / calls:.6f} ms", flush=True)
    print(f"vtm_mc_tiles [{label}]: {sum(c for c, _, _ in sizes.values())} calls "
          f"timed, kernel {sum(m for _, m, _ in sizes.values()):.6f} ms in all "
          f"(device), plain {sum(p for _, _, p in sizes.values()):.6f} ms", flush=True)


def pack_jobs(l0, l1, cargs, w: int, h: int, wc: int, hc: int, bd: int):
    """dmvr_final_pack's groups as (arguments, fir_blocks keywords)."""
    return ([(a, dict(w=w, h=h, taps=8, bd=bd)) for a in (l0, l1)]
            + [(a, dict(w=wc, h=hc, taps=4, bd=bd)) for a in cargs])


def pack_plain(RK, jobs):
    """dmvr_final_pack's flat output from the plain FIR, group by group."""
    import torch

    return torch.cat([RK.fir_blocks_plain(*a, **fk).reshape(-1) for a, fk in jobs])


def pack_1080p_case(rng, dev, n: int = 8100, bd: int = 8):
    """(l0, l1, cargs, keywords) of a dmvr_final_pack call the size of a 1080p
    4:2:0 picture of n 16x16 sub-PUs, numpy-seeded: both lists' luma (23x23
    buffers) and four chroma groups (11x11 buffers)."""
    from vtm_tpu_torch import testing as T
    from vtm_tpu_torch.ops.filter_chain import to_device

    l0, l1 = ([to_device(a, dev) for a in T.fir_blocks_case(rng, n, 8, 16, 16, bd)]
              for _ in range(2))
    cargs = [[to_device(a, dev) for a in T.fir_blocks_case(rng, n, 4, 8, 8, bd)]
             for _ in range(4)]
    return l0, l1, cargs, dict(w=16, h=16, wc=8, hc=8, bd=bd)


def fir_ops(jobs) -> int:
    """Multiply-adds of the FIR's two passes over its jobs."""
    return sum(a[0].shape[0] * ((fk["h"] + fk["taps"] - 1) * fk["w"] + fk["h"] * fk["w"])
               * fk["taps"] for a, fk in jobs)


def mc_1080p_cases(MK, rng, dev, bd: int = 8):
    """(label, planes, jobs, kw) of the MC batches the size of a 1080p 4:2:0
    picture, numpy-seeded from `rng`: 129,600 luma 4x4 tiles over 4
    reference planes of 1920x1080, 2 x 129,600 chroma 2x2 tiles over 4 of
    960x540, covering the planes in raster order, MVs off every edge."""
    import numpy as np

    from vtm_tpu_torch import testing as T
    from vtm_tpu_torch.ops.filter_chain import to_device

    for lum, (h, w), n in ((True, (1080, 1920), 129_600),
                           (False, (540, 960), 2 * 129_600)):
        refs = np.stack([T.plane(rng, h, w, bd) for _ in range(4)])
        planes = list(to_device(refs, dev))
        jobs = [to_device(a, dev) for a in T.mc_tiles_case(rng, refs, n, lum, bd, cover=True)]
        taps, tile = MK.SHAPES[lum]
        yield (f"1080p seeded {'luma' if lum else 'chroma'}, {n} tiles", planes, jobs,
               dict(taps=taps, tile=tile, bd=bd))


def check_inter_1080p(chk: KernelCheck, MK, RK, dev, seed: int = 9):
    """The four inter kernels on numpy-seeded batches the size of a 1080p
    4:2:0 picture, timed: the MC batches of `mc_1080p_cases`, and 8,100
    16x16 sub-PUs for the DMVR search, the luma FIR and BDOF."""
    import numpy as np

    from vtm_tpu_torch import testing as T
    from vtm_tpu_torch.ops.filter_chain import to_device

    rng = np.random.default_rng(seed)
    bd = 8

    def d(a):
        return to_device(a, dev)

    at = dict(timed=True, shape=SEEDED)
    for label, planes, jobs, kw in mc_1080p_cases(MK, rng, dev, bd):
        n, tile, taps = jobs[0].shape[0], kw["tile"], kw["taps"]
        chk.compare("vtm_mc_tiles", label,
                    lambda: MK.mc_tiles_cuda(planes, *jobs, **kw),
                    lambda: MK.mc_tiles_plain(planes, *jobs, **kw),
                    ins=(mc_ref_bytes(planes, jobs, taps, tile), jobs),
                    ops=mc_ops(n, taps, tile), **at)
    label = "1080p seeded, 8100 16x16"
    kw = dict(bd=bd, dx=16, dy=16)
    args = [d(a) for a in T.dmvr_case(rng, 8100, 16, 16, bd)]
    chk.compare("vtm_dmvr_search", f"{label} sub-PUs",
                lambda: RK.dmvr_search_cuda(*args, **kw),
                lambda: RK.dmvr_search_plain(*args, **kw),
                ins=args, ops=dmvr_ops(8100, 16, 16), **at)
    kw = dict(w=16, h=16, taps=8, bd=bd)
    args = [d(a) for a in T.fir_blocks_case(rng, 8100, 8, 16, 16, bd)]
    chk.compare("vtm_fir_blocks", f"{label} luma blocks",
                lambda: RK.fir_blocks_cuda(*args, **kw),
                lambda: RK.fir_blocks_plain(*args, **kw),
                ins=args, ops=fir_ops([(args, kw)]), **at)
    kw = dict(bd=bd, w=16, h=16)
    args = [d(a) for a in T.bdof_case(rng, 8100, 16, 16, bd)]
    chk.compare("vtm_bdof_blend", f"{label} sub-blocks",
                lambda: RK.bdof_blend_batch_cuda(*args, **kw),
                lambda: RK.bdof_blend_batch_plain(*args, **kw),
                ins=args, ops=bdof_ops(8100, 16, 16), **at)
    # the main path's form of the FIR: dmvr_final_pack's six groups, one launch
    l0, l1, cargs, kw = pack_1080p_case(rng, dev)
    jobs = pack_jobs(l0, l1, cargs, **kw)
    chk.compare("vtm_fir_blocks", f"{label}, dmvr_final_pack of 6 groups",
                lambda: RK.dmvr_final_pack(l0, l1, cargs, **kw),
                lambda: pack_plain(RK, jobs),
                ins=(l0, l1, cargs), ops=fir_ops(jobs), **at)


def satd_ops(RC, h: int, w: int) -> int:
    """Operations a sample of an h x w SATD takes at least: the butterflies
    of its tile (log2 of the tile's size) plus the absolute value and the
    sum; 2 for a block that falls back to the SAD."""
    kind = RC.satd_kind(h, w)
    if kind == RC.SAD:
        return 2
    th, tw = RC.KINDS[kind]
    return (th * tw).bit_length() - 1 + 2


def satd_inputs(rng, dev):
    """(h, w, bit depth, differences) of every tiling of SATD_SHAPES, 8- and
    10-bit (numpy-seeded, with the all-max, all-min and checkerboard
    extremes), 1920x1080 samples a call."""
    from vtm_tpu_torch import testing as T
    from vtm_tpu_torch.ops.filter_chain import to_device

    for h, w in SATD_SHAPES:
        n = 1920 * 1080 // (h * w)
        for bd in (8, 10):
            yield h, w, bd, to_device(T.satd_diffs(rng, n, h, w, bd), dev)


def check_satd(chk: KernelCheck, dev, seed: int = 11):
    """vtm_satd_batch against its plain version on satd_inputs, timed at 8
    bits, and on tiles where float32 and float64 normalisation differ."""
    import numpy as np

    from vtm_tpu_torch import testing as T
    from vtm_tpu_torch.ops import rdcost as RC
    from vtm_tpu_torch.ops.filter_chain import to_device

    rng = np.random.default_rng(seed)
    for h, w, bd, d in satd_inputs(rng, dev):
        chk.compare("vtm_satd_batch", f"{h}x{w} {bd}-bit, {d.shape[0]} blocks",
                    lambda: RC.satd_batch_cuda(d, h, w),
                    lambda: RC.satd_batch_plain(d, h, w), timed=bd == 8,
                    ins=d, ops=d.numel() * satd_ops(RC, h, w))
    for h, w in ((8, 16), (16, 8), (4, 8), (8, 4)):
        # tiles on which float32 and float64 normalisation differ
        d = to_device(T.satd_f32_cases(rng, h, w, 10), dev)
        chk.compare("vtm_satd_batch", f"{h}x{w}, {d.shape[0]} float32-edge tiles",
                    lambda: RC.satd_batch_cuda(d, h, w),
                    lambda: RC.satd_batch_plain(d, h, w))


def rmd_ops(RC, w: int, h: int, P: int, ncols: int) -> int:
    """Operations of an RMD class's columns at least: a prediction (4-tap:
    4 ops) and its SATD per sample, column and position."""
    return P * ncols * h * w * (4 + satd_ops(RC, h, w))


def rmd_jobs(RMD, src, bd: int):
    """(w, h, consts, srcpad, xs, ys) of every class of picture `src` on the
    card, MIP on, positions in the main path's order."""
    import numpy as np
    import torch

    from vtm_tpu_torch.encoder.enc_lib import EncoderConfig
    from vtm_tpu_torch.ops import upload

    dev = torch.device("cuda")
    h_pic, w_pic = src.shape
    cfg = EncoderConfig(width=w_pic, height=h_pic, bit_depth=bd, mip=True)
    srcpad = np.pad(src.astype(np.int32), ((1, RMD.PAD_R), (1, RMD.PAD_R)),
                    mode="edge")
    for w, h in RMD.intra_class_list(cfg):
        sx, sy = RMD._class_strides(w, h)
        gx, gy = np.meshgrid(np.arange(0, w_pic - w + 1, sx),
                             np.arange(0, h_pic - h + 1, sy))
        sp, xs, ys = upload([srcpad, gx.ravel(), gy.ravel()], dev)
        yield w, h, RMD.class_consts(w, h, bd, True, dev), sp, xs, ys


def reduce_agrees(red, lib) -> bool:
    """vtm_rmd_reduce's columns 0, 1, 3 and 4 against the two torch.min
    calls (values and first indices) over the angular and the MIP columns."""
    (av, ai), (mv, mi) = lib
    return all(bool((red[:, k].long() == v.long()).all())
               for k, v in ((0, av), (1, ai), (3, mv), (4, mi)))


def check_rmd(torch, chk: KernelCheck, src, bd: int, label: str, timed: bool,
              ptxas: dict | None = None, shape: str | None = None):
    """The three RMD kernels against their plain versions on every class of
    the source picture `src` (MIP on): the angular and the MIP columns, and
    the reduction of the plain table.  Timed (at `shape`, the picture's
    size_key): a line per class with its positions, operations, bound,
    times and launch shape (`ptxas`: the registers and spills of phase
    2)."""
    from vtm_tpu_torch.encoder import rmd as RMD
    from vtm_tpu_torch.ops import rdcost as RC

    total, per_class = 0, []
    for w, h, c, sp, xs, ys in rmd_jobs(RMD, src, bd):
        P = xs.shape[0]
        total += P
        out = torch.empty((P, c.ncols), dtype=torch.int32, device=sp.device)
        tag = f"{label} {w}x{h}, {P} positions"
        kw = dict(timed=timed, iters=2, shape=shape)
        ang = chk.compare(
            "vtm_rmd_angular", tag,
            lambda: RMD.angular_costs_cuda(sp, xs, ys, c, out)[:, :RMD.N_ANG],
            lambda: RMD.angular_costs_plain(sp, xs, ys, c, w, h, bd), **kw,
            ins=(sp, xs, ys), ops=rmd_ops(RC, w, h, P, RMD.N_ANG))
        t_ang = chk.last
        mip = chk.compare(
            "vtm_rmd_mip", tag,
            lambda: RMD.mip_costs_cuda(sp, xs, ys, c, out)[:, RMD.N_ANG:],
            lambda: RMD.mip_costs_plain(sp, xs, ys, c, w, h, bd), **kw,
            ins=(sp, xs, ys), ops=rmd_ops(RC, w, h, P, c.ncols - RMD.N_ANG))
        t_mip = chk.last
        full = torch.cat([ang, mip], dim=1)
        chk.compare("vtm_rmd_reduce", tag,
                    lambda: RMD.reduce_cuda(full, c.n_mip),
                    lambda: RMD.reduce_plain(full, c.n_mip), **kw,
                    ins=full, ops=2 * full.numel(), library=(
                        lambda: (torch.min(full[:, :RMD.N_ANG], 1),
                                 torch.min(full[:, RMD.N_ANG:], 1)),
                        reduce_agrees))
        if timed:
            per_class.append((w, h, P, RMD.kernel_config(w, h), t_ang, t_mip))
    print(f"RMD [{label}]: {total} positions in all classes", flush=True)
    for w, h, P, cfg, *times in per_class:
        parts = []
        for kern, t in zip(("angular", "mip"), times):
            bound, by = max((t["bytes"] / BYTES_PER_S * 1e3, "bytes"),
                            (t["ops"] / INT32_OPS_PER_S * 1e3, "operations"))
            k = cfg[kern]
            reg = (ptxas or {}).get(f"rmd_{kern}_kernel<{w}, {h}>", {})
            parts.append(
                f"{kern}: {t['ops']:.6g} ops, bound {bound:.6f} ms ({by}), kernel "
                f"{t['ms']:.6f} ms device ({100 * bound / t['ms']:.2f} % of bound), "
                f"{t['call_ms']:.6f} ms call, plain "
                f"{t['plain_ms']:.6f} ms; {k['threads']} threads, {k['smem_bytes']} "
                f"shared bytes, {k['blocks_per_sm']} blocks/SM, "
                f"{k['positions_per_block']} positions/block, {k['registers']} "
                f"registers, {reg.get('spill_stores', '?')}/{reg.get('spill_loads', '?')} "
                f"bytes spill stores/loads")
        print(f"RMD class {w}x{h} [{label}]: {P} positions; " + "; ".join(parts),
              flush=True)


def build_other(KN, other: str, source: str, names, defines=(), tag: str | None = None
                ) -> "ctypes.CDLL":
    """`source` of directory `other` (a path relative to it) built into
    other/libversus_<tag or stem>.so with its entry points renamed versus_*
    and `defines` (NAME=VALUE) set (a build of another commit beside this
    checkout's library); prints its ptxas lines."""
    import ctypes

    stem = tag or os.path.basename(source).split(".")[0]
    lib_path = os.path.join(other, f"libversus_{stem}.so")
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    res = subprocess.run([nvcc, *KN.NVCC_FLAGS, "-Xptxas", "-v", "-shared",
                          *(f"-D{n}=versus_{n[4:]}" for n in names),
                          *(f"-D{d}" for d in defines), "-o", lib_path,
                          os.path.join(other, source)],
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed on {other}/{source}:\n{res.stderr}")
    for name, r in ptxas_report(res.stderr).items():
        print(f"  ptxas [{other}]: {name}: {r}", flush=True)
    return ctypes.CDLL(lib_path)


def turns(torch, other_fn, this_fn, iters: int = 10):
    """Device ms of two builds in turns (other, this, this, other): (other
    mean, this mean, the four readings); a host-paced reading fails."""
    t = []
    for f in (other_fn, this_fn, this_fn, other_fn):
        ms, paced = device_ms(torch, f, iters)
        if paced:
            raise AssertionError(f"versus timing {paced}")
        t.append(ms)
    return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2, t


def versus(torch, other: str) -> int:
    """This checkout's kernels against another commit's build of the same
    sources in directory `other`, in one process on one card: the kernels
    of each of rmd.cu, deblock.cu, mc.cu, alf.cu, refine.cu, transform.cu,
    rdcost.cu, sao.cu and halo.cu that `other` holds."""
    from vtm_tpu_torch import kernels as KN

    print(card_line(), flush=True)
    for name, r in ptxas_report(KN.build(force=True, ptxas_verbose=True)).items():
        print(f"  ptxas: {name}: {r}", flush=True)
    runs = {"rmd.cu": versus_rmd, "deblock.cu": versus_deblock, "mc.cu": versus_mc,
            "alf.cu": versus_alf, "refine.cu": versus_refine,
            "transform.cu": versus_transform, "rdcost.cu": versus_satd,
            "sao.cu": versus_sao, "halo.cu": versus_halo}
    ran = [src for src in runs if os.path.exists(os.path.join(other, src))]
    if not ran:
        raise FileNotFoundError(f"{other} holds none of {', '.join(runs)}")
    for src in ran:
        runs[src](torch, KN, other)
    print(card_line(), flush=True)
    return 0


def other_entries(KN, other: str, source: str, names, defines=(), tag: str | None = None):
    """The renamed entry points `names` of `other`'s build of `source`, with
    this checkout's ctypes signatures."""
    import ctypes

    lib = build_other(KN, other, source, names, defines, tag)
    fns = []
    for n in names:
        fn = getattr(lib, f"versus_{n[4:]}")
        fn.argtypes = list(KN._SIGNATURES[n])
        fn.restype = ctypes.c_int
        fns.append(fn)
    return lib, fns


def versus_row(torch, other: str, name: str, label: str, other_fn, this_fn, theirs,
               ins, sums: dict, ops: float = 0, peak: float = INT32_OPS_PER_S):
    """One row of --versus: the other build's call (it must launch), this
    build's output held equal to its `theirs`, both timed in turns; prints
    the row with each build's share of the bound (the bytes of `ins` and
    the output, or `ops` operations at `peak` a second (int32 lanes unless
    given), whichever takes longer), adds (other ms, this ms, bytes, ops,
    ops ms) to sums[name], and returns this build's output."""
    if other_fn() != 0:
        raise RuntimeError(f"{other}: {name} refused")
    mine = this_fn()
    torch.cuda.synchronize()
    err = max_err(torch, mine, theirs)
    if err:
        raise AssertionError(f"{name} {label}: this build and {other} differ by {err}")
    o_ms, t_ms, t = turns(torch, other_fn, this_fn)
    nb = nbytes(ins, mine)
    bound = max(nb / BYTES_PER_S, ops / peak) * 1e3
    acc = sums.setdefault(name, [0.0, 0.0, 0, 0, 0.0])
    for k, v in enumerate((o_ms, t_ms, nb, ops, ops / peak * 1e3)):
        acc[k] += v
    print(f"versus {name} {label}: other {o_ms:.6f} ms, this {t_ms:.6f} ms "
          f"({o_ms / t_ms:.2f}x; turns {', '.join(f'{x:.6f}' for x in t)}), {nb} bytes, "
          f"{ops:.6g} ops, bound {bound:.6f} ms ({100 * bound / t_ms:.2f} % this, "
          f"{100 * bound / o_ms:.2f} % other), outputs equal", flush=True)
    return mine


def versus_sums(sums: dict, what: str) -> None:
    for name, (o_ms, t_ms, nb, ops, ops_ms) in sums.items():
        bound = max(nb / BYTES_PER_S * 1e3, ops_ms)
        print(f"versus sum {name} ({what}): other {o_ms:.6f} ms, this {t_ms:.6f} ms "
              f"({o_ms / t_ms:.2f}x), {nb} bytes, {ops:.6g} ops, bound {bound:.6f} ms "
              f"({100 * bound / t_ms:.2f} % this, {100 * bound / o_ms:.2f} % other)",
              flush=True)


def versus_mc(torch, KN, other: str) -> None:
    """vtm_mc_tiles against the build of another mc.cu (with its fir.cuh and
    common.cuh) in `other`, on phase 3's 1080p seeded luma and chroma
    batches, in turns.  The other build (commit 165e438 and before) reads
    the plane pointers from a device table: uploaded once, outside the
    timed calls."""
    import numpy as np

    from vtm_tpu_torch.ops import mc_kernel as MK

    _, (fn,) = other_entries(KN, other, "mc.cu", ("vtm_mc_tiles",))
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    sums = {}
    for label, planes, jobs, kw in mc_1080p_cases(MK, np.random.default_rng(9), dev):
        n, tile = jobs[0].shape[0], kw["tile"]
        table = torch.tensor([p.data_ptr() for p in planes], dtype=torch.int64, device=dev)
        mine = torch.empty((n, tile, tile), dtype=torch.int32, device=dev)
        theirs = torch.full_like(mine, -1)
        versus_row(
            torch, other, "vtm_mc_tiles", label,
            lambda: fn(table.data_ptr(), len(planes), *planes[0].shape,
                       *(a.data_ptr() for a in jobs), n, kw["taps"], tile, kw["bd"],
                       theirs.data_ptr(), stream),
            lambda: MK.mc_tiles_cuda(planes, *jobs, **kw, out=mine), theirs,
            (planes, jobs), sums)
    versus_sums(sums, "luma + chroma")


def alf_cases(torch, pic: dict, dev):
    """The vtm_alf_classify call of a captured picture's chain, as (y_pad,
    its seven row tables), its vtm_alf_filter calls, as (label, src_pad,
    coef, clip, o_rows, near_vb, taps) of Y, Cb and Cr, and the bit depth:
    the chain up to SAO on the card (chain_body with ALF off), then the
    luma classes and the per-CTU coefficient gather, as phase 3 takes
    them.  ALF must be on in every component."""
    from vtm_tpu_torch.ops import alf_kernel as AK
    from vtm_tpu_torch.ops import edge_pad
    from vtm_tpu_torch.ops import filter_chain as FC

    planes, lmcs_lut, dmaps, sao_maps, alf_tables, bd, sx, sy = (pic[k] for k in (
        "planes", "lmcs_lut", "dmaps", "sao_maps", "alf_tables", "bd", "sx", "sy"))
    fl = FC.chain_flags(len(planes), lmcs_lut, dmaps, sao_maps, alf_tables)
    if not all(fl[10:13]):
        raise AssertionError("the picture's ALF is off in a component")
    comps = [FC.to_device(p, dev) for p in planes]
    dbv, dbh, sao, alf = FC.maps_to_torch(dmaps, sao_maps, alf_tables, dev)
    lut = FC.to_device(lmcs_lut, dev) if lmcs_lut is not None else None
    flat = FC.chain_body(*comps, lut, dbv, dbh, sao, alf, bd, sx, sy, fl[:10] + (False,) * 5)
    y, cb, cr = (p.view_as(c) for p, c in zip(flat.split([c.numel() for c in comps]), comps))
    (cperm, lperm, ctu_of, l_orows, l_near, y_i, yd_i, yu_i, yu2_i, df, dl, mult,
     cb_coef, cb_clip, cr_coef, cr_clip, c_orows, c_near) = alf[:18]
    y_pad = edge_pad(y, AK.PAD, AK.PAD)
    rows = (y_i, yd_i, yu_i, yu2_i, df, dl, mult)
    cls, tr = AK.classify_picture_cuda(y_pad, *rows, bit_depth=bd)
    gather = (ctu_of.long(), cls.long(), tr.long())
    cases = [("luma", y_pad, cperm[gather], lperm[gather], l_orows, l_near, AK.LUMA_TAPS)]
    for label, c, co, cl in (("Cb", cb, cb_coef, cb_clip), ("Cr", cr, cr_coef, cr_clip)):
        cases.append((label, edge_pad(c, AK.PAD, AK.PAD), co, cl, c_orows, c_near,
                      AK.CHROMA_TAPS))
    return (y_pad, rows), cases, bd


def versus_alf(torch, KN, other: str) -> None:
    """vtm_alf_classify and vtm_alf_filter against the build of another
    alf.cu (with its common.cuh) in `other`, on the classifier's input and
    the luma, Cb and Cr filter inputs of POC 0 of the 1080p stream, in
    turns."""
    from vtm_tpu_torch.ops import alf_kernel as AK
    from vtm_tpu_torch.parallel import multichip as MCH

    names = ("vtm_alf_classify", "vtm_alf_filter", "vtm_ccalf_filter")
    _, (cls_fn, fn, _) = other_entries(KN, other, "alf.cu", names)
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    (y_pad, rows), cases, bd = alf_cases(
        torch, MCH.capture_decode(HD_STREAM, "cuda")["pics"][0], dev)
    nr = rows[0].shape[0]
    H4, W4 = (nr - 2) // 2, (y_pad.shape[1] - 2 * AK.PAD) // 4
    theirs = tuple(torch.full((H4, W4), -1, dtype=torch.int32, device=dev) for _ in range(2))
    versus_row(
        torch, other, "vtm_alf_classify", "POC 0 luma",
        lambda: cls_fn(y_pad.data_ptr(), *y_pad.shape, *(r.data_ptr() for r in rows[:4]), nr,
                       *(r.data_ptr() for r in rows[4:]), H4, W4, bd, theirs[0].data_ptr(),
                       theirs[1].data_ptr(), stream),
        lambda: AK.classify_picture_cuda(y_pad, *rows, bit_depth=bd), theirs,
        (y_pad, rows), {})
    sums = {}
    for label, pad, coef, clip, orows, near, taps in cases:
        H, W = orows.shape[0], coef.shape[1] * 4
        theirs = torch.full((H, W), -1, dtype=torch.int32, device=dev)
        versus_row(
            torch, other, "vtm_alf_filter", f"POC 0 {label}",
            lambda: fn(pad.data_ptr(), *pad.shape, coef.data_ptr(), clip.data_ptr(),
                       int(taps == AK.LUMA_TAPS), orows.data_ptr(), near.data_ptr(), H, W,
                       bd, theirs.data_ptr(), stream),
            lambda: AK.alf_filter_cuda(pad, coef, clip, orows, near, taps=taps,
                                       bit_depth=bd), theirs,
            (pad, coef, clip, orows, near), sums)
    versus_sums(sums, "Y + Cb + Cr")


def versus_rmd(torch, KN, other: str) -> None:
    """vtm_rmd_angular, vtm_rmd_mip and vtm_rmd_reduce against the build of
    another rmd.cu in `other` (with its satd.cuh and common.cuh; commit
    8391984 or later: the compact class table), per class of the 1080p
    source, in turns; prints a line per class for the angular and MIP
    kernels (operation bound), a versus row per class for the reduction
    (bytes bound), and the sums."""
    from vtm_tpu_torch import testing as T
    from vtm_tpu_torch.encoder import rmd as RMD
    from vtm_tpu_torch.ops import rdcost as RC

    lib, _ = other_entries(KN, other, "rmd.cu",
                           ("vtm_rmd_angular", "vtm_rmd_mip", "vtm_rmd_reduce"))
    stream = torch.cuda.current_stream().cuda_stream
    sums = {k: [0.0, 0.0, 0.0] for k in ("angular", "mip")}  # other, this, ops
    red_sums = {}
    for w, h, c, sp, xs, ys in rmd_jobs(RMD, T.hd_source()[0], 8):
        P = xs.shape[0]
        mine = torch.empty((P, c.ncols), dtype=torch.int32, device="cuda")
        theirs = torch.full_like(mine, -1)
        pos = (sp.data_ptr(), *sp.shape, xs.data_ptr(), ys.data_ptr(), P)
        runs = {
            "angular": (lambda: RMD.angular_costs_cuda(sp, xs, ys, c, mine),
                        lambda: lib.versus_rmd_angular(*pos, c.tab.data_ptr(), w, h, 8,
                                                       theirs.data_ptr(), c.ncols, stream),
                        RMD.N_ANG),
            "mip": (lambda: RMD.mip_costs_cuda(sp, xs, ys, c, mine),
                    lambda: lib.versus_rmd_mip(*pos, c.wadj.data_ptr(), c.n_mip, w, h, 8,
                                               theirs.data_ptr(), c.ncols, stream),
                    c.ncols - RMD.N_ANG)}
        line = []
        for kern, (this_fn, other_fn, ncols) in runs.items():
            if other_fn() != 0:
                raise RuntimeError(f"{other}: {kern} {w}x{h} refused")
            o_ms, t_ms, t = turns(torch, other_fn, this_fn, 5)
            ops = rmd_ops(RC, w, h, P, ncols)
            bound = ops / INT32_OPS_PER_S * 1e3
            for k, v in enumerate((o_ms, t_ms, ops)):
                sums[kern][k] += v
            line.append(f"{kern} other {o_ms:.6f} ms, this {t_ms:.6f} ms "
                        f"({o_ms / t_ms:.2f}x; turns {', '.join(f'{x:.6f}' for x in t)}), "
                        f"op bound {bound:.6f} ms ({100 * bound / t_ms:.2f} % this, "
                        f"{100 * bound / o_ms:.2f} % other)")
        torch.cuda.synchronize()
        err = max_err(torch, mine, theirs)
        if err:
            raise AssertionError(f"{w}x{h}: this build and {other} differ by {err}")
        print(f"versus {w}x{h}, {P} positions: " + "; ".join(line) + ", outputs equal",
              flush=True)
        red = torch.full((P, 5), -1, dtype=torch.int32, device="cuda")
        versus_row(torch, other, "vtm_rmd_reduce", f"{w}x{h}, {P} positions",
                   lambda: lib.versus_rmd_reduce(mine.data_ptr(), P, c.ncols, 2 * c.n_mip,
                                                 red.data_ptr(), stream),
                   lambda: RMD.reduce_cuda(mine, c.n_mip), red, mine, red_sums)
    for kern, (o_ms, t_ms, ops) in sums.items():
        bound = ops / INT32_OPS_PER_S * 1e3
        print(f"versus sum {kern}: other {o_ms:.6f} ms, this {t_ms:.6f} ms "
              f"({o_ms / t_ms:.2f}x), op bound {bound:.6f} ms ({100 * bound / t_ms:.2f} "
              f"% this, {100 * bound / o_ms:.2f} % other)", flush=True)
    versus_sums(red_sums, "17 classes")


def versus_refine(torch, KN, other: str) -> None:
    """The kernels of refine.cu against the build of another refine.cu in
    `other` (with its fir.cuh and common.cuh), in turns, outputs held
    equal.  vtm_dmvr_search and vtm_bdof_blend on the inputs of every call
    of the RA decode (recorded from this build's own decode, one row a
    call, then their sum) and on 8,100 seeded 16x16 sub-PUs or sub-blocks;
    vtm_fir_blocks on phase 3's 1080p-sized 8,100 16x16 luma blocks, and
    on a dmvr_final_pack call of 8,100 16x16 sub-PUs (six groups): an
    entry point of job groups (`int ngroups`, as here) gets the six groups
    in one launch; the older one (commit 760a03e and before: one group a
    launch, the arguments one by one) six launches, timed as one call."""
    import ctypes

    import numpy as np

    from vtm_tpu_torch import testing as T
    from vtm_tpu_torch.decoder.declib import Decoder
    from vtm_tpu_torch.ops import mc_kernel as MK
    from vtm_tpu_torch.ops import refine_kernel as RK
    from vtm_tpu_torch.ops.filter_chain import to_device

    lib = build_other(KN, other, "refine.cu",
                      ("vtm_dmvr_search", "vtm_fir_blocks", "vtm_bdof_blend"))
    with open(os.path.join(other, "refine.cu")) as f:
        grouped = "int ngroups" in f.read()
    fir = lib.versus_fir_blocks
    P, I = ctypes.c_void_p, ctypes.c_int
    fir.argtypes = (list(KN._SIGNATURES["vtm_fir_blocks"]) if grouped
                    else [P, I, I, I, P, P, P, P, I, I, I, I, P, P])
    fir.restype = ctypes.c_int
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    rng = np.random.default_rng(9)
    bd = 8

    def other_fir(groups, flat):
        """The other build's launch (grouped) or launches (one a group),
        into `flat`."""
        errs, pos, ptrs, dims = [], 0, [], []
        for a, fk in groups:
            bufs, x0, y0, cfh, cfv = a
            n, H, W = bufs.shape
            if grouped:
                ptrs += [t.data_ptr() for t in a]
                dims += [n, H, W, fk["w"], fk["h"], fk["taps"], pos]
            else:
                errs.append(fir(bufs.data_ptr(), n, H, W, x0.data_ptr(), y0.data_ptr(),
                                cfh.data_ptr(), cfv.data_ptr(), fk["w"], fk["h"],
                                fk["taps"], fk["bd"], flat[pos:].data_ptr(), stream))
            pos += n * fk["h"] * fk["w"]
        if grouped:
            p = (ctypes.c_void_p * len(ptrs))(*ptrs)
            d = (ctypes.c_int * len(dims))(*dims)
            errs.append(fir(len(groups), ctypes.addressof(p), ctypes.addressof(d), bd,
                            flat.data_ptr(), stream))
        return max(errs)

    sums = {}
    args = [to_device(a, dev) for a in T.fir_blocks_case(rng, 8100, 8, 16, 16, bd)]
    kw = dict(w=16, h=16, taps=8, bd=bd)
    mine = torch.empty((8100, 16, 16), dtype=torch.int32, device=dev)
    theirs = torch.full_like(mine, -1)
    versus_row(torch, other, "vtm_fir_blocks", "1080p seeded, 8100 16x16 luma blocks",
               lambda: other_fir([(args, kw)], theirs.view(-1)),
               lambda: RK.fir_blocks_cuda(*args, **kw, out=mine), theirs, args, sums)
    l0, l1, cargs, kw = pack_1080p_case(rng, dev)
    jobs = pack_jobs(l0, l1, cargs, **kw)
    theirs = torch.full((sum(a[0].shape[0] * fk["h"] * fk["w"] for a, fk in jobs),), -1,
                        dtype=torch.int32, device=dev)
    versus_row(torch, other, "vtm_fir_blocks",
               "1080p seeded, dmvr_final_pack of 8100 16x16 sub-PUs (6 groups; other: "
               f"{'1 launch' if grouped else '6 launches'})", lambda: other_fir(jobs, theirs),
               lambda: RK.dmvr_final_pack(l0, l1, cargs, **kw), theirs, (l0, l1, cargs), sums)
    versus_sums(sums, "luma blocks + dmvr_final_pack")
    versus_search_blend(torch, KN, other, lib, capture_inter_inputs(MK, RK, Decoder)[0],
                        rng)


def versus_search_blend(torch, KN, other: str, lib, got: dict, rng) -> None:
    """--versus rows of vtm_dmvr_search and vtm_bdof_blend: the other
    build's entries of `lib` against this build's wrappers, on the RA
    decode's recorded calls (`got`, from capture_inter_inputs) and on 8,100
    seeded 16x16 sub-PUs and sub-blocks; the bound counts the inputs and
    the output, and the operations of dmvr_ops and bdof_ops."""
    import ctypes

    from vtm_tpu_torch import testing as T
    from vtm_tpu_torch.ops import refine_kernel as RK
    from vtm_tpu_torch.ops.filter_chain import to_device

    search, blend = lib.versus_dmvr_search, lib.versus_bdof_blend
    for fn, name in ((search, "vtm_dmvr_search"), (blend, "vtm_bdof_blend")):
        fn.argtypes = list(KN._SIGNATURES[name])
        fn.restype = ctypes.c_int
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    bil = RK._bilinear_table(dev).data_ptr()

    def search_row(label, args, kw, sums):
        n = args[0].shape[0]
        theirs = torch.full((3, n), -1, dtype=torch.int32, device=dev)
        versus_row(torch, other, "vtm_dmvr_search", f"{label}, {n} {kw['dx']}x{kw['dy']} "
                   "sub-PUs", lambda: search(*(a.data_ptr() for a in args), bil, n, kw["dx"],
                                            kw["dy"], kw["bd"], theirs.data_ptr(), stream),
                   lambda: RK.dmvr_search_cuda(*args, **kw), theirs, args, sums,
                   ops=dmvr_ops(n, kw["dx"], kw["dy"]))

    def blend_row(label, args, kw, sums):
        n = args[0].shape[0]
        theirs = torch.full((n, kw["h"], kw["w"]), -1, dtype=torch.int32, device=dev)
        versus_row(torch, other, "vtm_bdof_blend", f"{label}, {n} {kw['w']}x{kw['h']} "
                   "sub-blocks", lambda: blend(args[0].data_ptr(), args[1].data_ptr(), n,
                                              kw["w"], kw["h"], kw["bd"], theirs.data_ptr(),
                                              stream),
                   lambda: RK.bdof_blend_batch_cuda(*args, **kw), theirs, args, sums,
                   ops=bdof_ops(n, kw["w"], kw["h"]))

    sums = {}
    for args, kw in got["search"]:
        search_row(RA_STREAM, args, kw, sums)
    for args, kw in got["bdof"]:
        blend_row(RA_STREAM, args, kw, sums)
    versus_sums(sums, f"the {RA_STREAM} decode's calls")
    bd = 8
    args = [to_device(a, dev) for a in T.dmvr_case(rng, 8100, 16, 16, bd)]
    search_row("1080p seeded", args, dict(bd=bd, dx=16, dy=16), {})
    args = [to_device(a, dev) for a in T.bdof_case(rng, 8100, 16, 16, bd)]
    blend_row("1080p seeded", args, dict(bd=bd, w=16, h=16), {})


def versus_transform(torch, KN, other: str) -> None:
    """vtm_inv_transform and vtm_inv_transform_s8 against the build of
    another transform.cu in `other` (with its common.cuh, and its tc.cuh
    where it has one), in turns, on numpy-seeded int16-range coefficients
    at 8 bits: vtm_inv_transform on DCT2 blocks, the sharded
    reconstruction's lane slices of 32x32 blocks (4,080 on 1 x 1 lanes,
    1,020 on 2 x 2), then the square sizes 8 to 64, each a batch the size of
    a 1920x1080 plane; vtm_inv_transform_s8 on 1080p-plane batches of the
    square DCT2 sizes 2 to 64 (a sum; tensor-core operations bound, below
    the bytes), each also timed in turns with this build's
    vtm_inv_transform on the same blocks, and of 4x16 DST7 / DCT8 and 64x2
    DCT2 blocks (small blocks packed into tiles, a ragged last group)."""
    import numpy as np

    from vtm_tpu_torch.ops import transform as TR

    _, (fn, fn_s8, _) = other_entries(KN, other, "transform.cu",
                                      ("vtm_inv_transform", "vtm_inv_transform_s8",
                                       "vtm_recon_sse"))
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    rng = np.random.default_rng(17)

    def coeffs(nb, h, w):
        return torch.from_numpy(rng.integers(-32768, 32768, size=(nb, h, w))
                                .astype(np.int32)).to(dev)

    cases = [(f"lane 0 of sharded_recon_step on {lanes} lanes", nb, 32)
             for lanes, nb in (("1 x 1", 4080), ("2 x 2", 1020))]
    cases += [("1080p plane", 1920 * 1080 // (n * n), n) for n in (8, 16, 32, 64)]
    sums = {}
    for label, nb, n in cases:
        c = coeffs(nb, n, n)
        tv = TR._tmat(TR.DCT2, n, dev)
        theirs = torch.full_like(c, -1)
        versus_row(torch, other, "vtm_inv_transform", f"{label}, {nb} {n}x{n} DCT2 blocks",
                   lambda: fn(c.data_ptr(), theirs.data_ptr(), tv.data_ptr(), tv.data_ptr(),
                              nb, n, n, 8, stream),
                   lambda: TR.inv_transform_batch_cuda(c, 8), theirs, c,
                   sums if label == "1080p plane" else {}, ops=nb * n * n * 2 * n)
    versus_sums(sums, "DCT2 8-64 on 1080p planes")
    sums = {}
    for h, w, tr_hor, tr_ver in [(n, n, TR.DCT2, TR.DCT2) for n in (2, 4, 8, 16, 32, 64)] + [
            (4, 16, TR.DST7, TR.DCT8), (64, 2, TR.DCT2, TR.DCT2)]:
        nb = 1920 * 1080 // (h * w)
        c = coeffs(nb, h, w)
        tv, th = TR._tmat(tr_ver, h, dev), TR._tmat(tr_hor, w, dev)
        theirs = torch.full_like(c, -1)
        square = h == w
        label = f"1080p plane, {nb} {h}x{w} kinds {(tr_hor, tr_ver)} blocks"
        mine = versus_row(
            torch, other, "vtm_inv_transform_s8", label,
            lambda: fn_s8(c.data_ptr(), theirs.data_ptr(), tv.data_ptr(), th.data_ptr(),
                          nb, h, w, 8, stream),
            lambda: TR.inv_transform_batch_s8_cuda(c, 8, tr_hor, tr_ver), theirs, c,
            sums if square else {}, ops=4 * nb * h * w * (h + w), peak=INT8_TC_OPS_PER_S)
        if square:
            if not torch.equal(mine, TR.inv_transform_batch_cuda(c, 8)):
                raise AssertionError(f"vtm_inv_transform != vtm_inv_transform_s8 [{label}]")
            s8_ms, i32_ms, t = turns(torch, lambda: TR.inv_transform_batch_s8_cuda(c, 8),
                                     lambda: TR.inv_transform_batch_cuda(c, 8))
            print(f"versus this s8 / int32 {h}x{w}: vtm_inv_transform_s8 {s8_ms:.6f} ms, "
                  f"vtm_inv_transform {i32_ms:.6f} ms (turns "
                  f"{', '.join(f'{x:.6f}' for x in t)}), faster: "
                  f"{'vtm_inv_transform_s8' if s8_ms < i32_ms else 'vtm_inv_transform'}",
                  flush=True)
    versus_sums(sums, "DCT2 2-64 on 1080p planes")


def versus_deblock(torch, KN, other: str) -> None:
    """vtm_deblock_luma_ver and vtm_deblock_chroma_ver against the build of
    another deblock.cu in `other` (its entry points renamed), on the chain
    inputs of POC 0 of the 1080p stream, VER then HOR (HOR filters VER's
    output, as the chain does), then vtm_deblock_luma_ver_delta on its
    eight VER and eight HOR shards (delta_shards), in turns (other, this,
    this, other), in device ms.  The other deblock.cu must be commit 165e438
    or later, whose entry points take this build's arguments (Cb and Cr in
    one chroma launch).  Each output must equal the other build's; each row
    prints its share of the bytes bound for both builds, and the launch
    shape of this build's tile kernels."""
    from vtm_tpu_torch.ops import deblock_kernel as DK
    from vtm_tpu_torch.ops import filter_chain as FC
    from vtm_tpu_torch.parallel import multichip as MCH

    lib, _ = other_entries(KN, other, "deblock.cu", (
        "vtm_deblock_luma_ver", "vtm_deblock_chroma_ver", "vtm_deblock_luma_ver_delta"))
    for name, cfg in (DK.kernel_config() | halo_config(KN)).items():
        print(f"  launch shape {name}: {cfg}", flush=True)

    dev = torch.device("cuda")
    pic = MCH.capture_decode(HD_STREAM, "cuda")["pics"][0]
    planes, lmcs_lut, dmaps, sao_maps, alf_tables, bd, sx, sy = (pic[k] for k in (
        "planes", "lmcs_lut", "dmaps", "sao_maps", "alf_tables", "bd", "sx", "sy"))
    fl = FC.chain_flags(len(planes), lmcs_lut, dmaps, sao_maps, alf_tables)
    y, cb, cr = (FC.to_device(p, dev) for p in planes)
    dbv, dbh, _, _ = FC.maps_to_torch(dmaps, sao_maps, alf_tables, dev)
    if fl[0]:
        y = FC.to_device(lmcs_lut, dev)[y.long()]
    stream = torch.cuda.current_stream().cuda_stream
    sums = {}
    for hor, maps, (hl, hcb, hcr) in ((False, dbv, fl[1:4]), (True, dbh, fl[4:7])):
        if not (hl and hcb and hcr):
            raise AssertionError(f"POC 0 of {HD_STREAM}: a component is not deblocked")
        kw = dict(bit_depth=bd, hor=hor, sx=sx, sy=sy)
        lk = dict(kw, has_l=True, has_cb=False, has_cr=False)
        ck = dict(kw, has_l=False, has_cb=True, has_cr=True)
        yv, mv = (y.T, maps[0].T) if hor else (y, maps[0])
        loop_len, dec_line, step = DK._chroma_geometry(hor, sx, sy)
        pv = cb.T if hor else cb
        cv = (maps[7].T if hor else maps[7])[:, ::step]
        o_y, o_cb, o_cr = (torch.full_like(p, -1) for p in (y, cb, cr))

        def other_luma():
            return lib.versus_deblock_luma_ver(
                y.data_ptr(), o_y.data_ptr(), *yv.shape, *yv.stride(),
                *(m.data_ptr() for m in maps[0:7]), *mv.stride(), bd, stream)

        def other_chroma():
            return lib.versus_deblock_chroma_ver(
                cb.data_ptr(), o_cb.data_ptr(), cr.data_ptr(), o_cr.data_ptr(),
                *pv.shape, *pv.stride(), *(m.data_ptr() for m in maps[7:17]),
                *cv.stride(), pv.shape[0] // loop_len, pv.shape[1] // 4, loop_len,
                dec_line, bd, stream)

        rows = (("vtm_deblock_luma_ver", other_luma,
                 lambda: DK.deblock_dir_cuda(y, cb, cr, *maps, **lk)[0:1], (o_y,),
                 (y, maps[0:7])),
                ("vtm_deblock_chroma_ver", other_chroma,
                 lambda: DK.deblock_dir_cuda(y, cb, cr, *maps, **ck)[1:], (o_cb, o_cr),
                 (cb, cr, maps[7:17])))
        (y,), (cb, cr) = (
            tuple(versus_row(torch, other, name, "HOR" if hor else "VER", other_fn,
                             this_fn, theirs, ins, sums))
            for name, other_fn, this_fn, theirs, ins in rows)
    versus_sums(sums, "VER + HOR")
    # the delta form on the multi-device path's shards
    shards, _, bd = delta_shards(torch, pic, dev)
    for d in ("VER", "HOR"):
        dsums = {}
        for label, pad, m in (c for c in shards if c[0].startswith(d)):
            theirs = torch.full_like(pad, -1)
            versus_row(
                torch, other, "vtm_deblock_luma_ver_delta", label,
                lambda: lib.versus_deblock_luma_ver_delta(
                    pad.data_ptr(), theirs.data_ptr(), *pad.shape,
                    *(t.data_ptr() for t in m), bd, stream),
                lambda: DK.luma_ver_delta_cuda(pad, *m, bd), theirs, (pad, m), dsums)
        versus_sums(dsums, f"8 {d} shards")


def versus_satd(torch, KN, other: str) -> None:
    """vtm_satd_batch against the build of another rdcost.cu (with its
    satd.cuh and common.cuh) in `other`, on phase 3's 13 timed tilings (8
    bits, 1920x1080 samples each, satd_inputs), in turns."""
    import numpy as np

    from vtm_tpu_torch.ops import rdcost as RC

    _, (fn,) = other_entries(KN, other, "rdcost.cu", ("vtm_satd_batch",))
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    sums = {}
    for h, w, bd, d in satd_inputs(np.random.default_rng(11), dev):
        if bd != 8:
            continue
        n = d.shape[0]
        theirs = torch.full((n,), -1, dtype=torch.int32, device=dev)
        versus_row(torch, other, "vtm_satd_batch", f"{h}x{w}, {n} blocks",
                   lambda: fn(d.data_ptr(), theirs.data_ptr(), n, h, w, stream),
                   lambda: RC.satd_batch_cuda(d, h, w), theirs, d, sums,
                   ops=d.numel() * satd_ops(RC, h, w))
    versus_sums(sums, f"{len(SATD_SHAPES)} tilings")


def sao_chain_inputs(torch, pic: dict, dev):
    """The vtm_sao_apply calls of a captured picture's chain, as [(label,
    plane, (type_map, ctu_map, offsets, valid))] for the planes with SAO;
    all three planes after LMCS and both deblocking directions (the kernels
    on CUDA tensors); and the bit depth."""
    from vtm_tpu_torch.ops import deblock_kernel as DK
    from vtm_tpu_torch.ops import filter_chain as FC

    planes, lmcs_lut, dmaps, sao_maps, alf_tables, bd, sx, sy = (pic[k] for k in (
        "planes", "lmcs_lut", "dmaps", "sao_maps", "alf_tables", "bd", "sx", "sy"))
    fl = FC.chain_flags(len(planes), lmcs_lut, dmaps, sao_maps, alf_tables)
    y, cb, cr = (FC.to_device(p, dev) for p in planes)
    dbv, dbh, sao, _ = FC.maps_to_torch(dmaps, sao_maps, alf_tables, dev)
    if fl[0]:
        y = FC.to_device(lmcs_lut, dev)[y.long()]
    for hor, maps, (hl, hcb, hcr) in ((False, dbv, fl[1:4]), (True, dbh, fl[4:7])):
        y, cb, cr = DK.deblock_dir(y, cb, cr, *maps, bit_depth=bd, hor=hor, sx=sx, sy=sy,
                                   has_l=hl, has_cb=hcb, has_cr=hcr)
    return [(label, p, sao[c]) for c, (label, p) in enumerate((("Y", y), ("Cb", cb),
                                                               ("Cr", cr)))
            if sao[c] is not None], (y, cb, cr), bd


def seeded_sao_maps(torch, plane, rng, ctu: int = 64):
    """SAO maps for a plane whose picture has none: per ctu x ctu CTU a
    type 0-4 and SAO on or off (half of them), offsets -7..7; numpy-seeded."""
    import numpy as np

    H, W = plane.shape
    rows, cols = -(-H // ctu), -(-W // ctu)
    grid = np.arange(rows * cols, dtype=np.int32).reshape(rows, cols)
    ctu_map = np.repeat(np.repeat(grid, ctu, 0), ctu, 1)[:H, :W]
    types = rng.integers(0, 5, rows * cols)
    on = rng.random(rows * cols) < 0.5
    offsets = rng.integers(-7, 8, (rows * cols, 32))
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(plane.device) for a in (
        types[ctu_map].astype(np.int32), ctu_map.astype(np.int32),
        offsets.astype(np.int32), on[ctu_map]))


def sao_ext_shards(torch, pic: dict, dev, lanes: int = 8, maps=None):
    """The vtm_sao_apply_ext calls of the sharded luma chain over `lanes`
    width shards of a captured picture, as [(label, (pad, type_map, ctu_map,
    offsets, valid, bd))]: each shard extended by its neighbours' column
    (edge copies at the picture border) and one edge row
    (pic_shard.make_sharded_luma_filters), on the picture's luma as the
    chain's input holds it, with its luma SAO maps or `maps` (type_map,
    ctu_map, offsets, valid) in their place; also the unextended shards."""
    from vtm_tpu_torch.parallel import pic_shard as PS

    x, _, _, sao, _, _ = PS.luma_chain_args(pic)
    sao = sao if maps is None else maps
    bd = int(pic["bd"])
    devs = [dev] * lanes
    xs = PS._split_cols(PS._t(x), lanes, devs)
    parts = [PS._split_cols(PS._t(m), lanes, devs) for m in (sao[0], sao[1], sao[3])]
    offs = PS._t(sao[2]).to(dev)
    return [(f"shard {i} of {lanes}",
             (e, parts[0][i], parts[1][i], offs, parts[2][i], bd))
            for i, e in enumerate(PS._halo_cols(xs, 1, pad=1))], xs


def versus_sao(torch, KN, other: str) -> None:
    """vtm_sao_apply_ext and vtm_sao_apply against the build of another
    sao.cu (with its common.cuh) in `other`, in turns: the first on the
    eight 240-column VER shards (sao_ext_shards) of each picture of the
    1080p stream with luma SAO, and of POC 0's luma with seeded maps (half
    the CTUs on, seeded_sao_maps), a sum a set; the second on POC 0's Y, Cb
    and Cr (sao_chain_inputs; a plane without SAO in that picture with
    seeded maps)."""
    import numpy as np

    from vtm_tpu_torch.ops import sao_kernel as SK
    from vtm_tpu_torch.parallel import multichip as MCH
    from vtm_tpu_torch.parallel import pic_shard as PS

    _, (plane_fn, ext_fn) = other_entries(KN, other, "sao.cu",
                                          ("vtm_sao_apply", "vtm_sao_apply_ext"))
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    pics = MCH.capture_decode(HD_STREAM, "cuda")["pics"]
    pic = pics[0]

    def other_call(fn, src, tmap, cmap, offs, valid, bd, out):
        H, W = tmap.shape
        return fn(src.data_ptr(), out.data_ptr(), tmap.data_ptr(), cmap.data_ptr(),
                  offs.data_ptr(), valid.data_ptr(), H, W, offs.shape[0], bd, stream)

    sets = [(f"POC {k}", sao_ext_shards(torch, p, dev)[0]) for k, p in enumerate(pics)
            if PS.luma_chain_args(p)[3] is not None]
    luma = torch.from_numpy(PS.luma_chain_args(pic)[0]).to(dev)
    maps = seeded_sao_maps(torch, luma, np.random.default_rng(31))
    sets.append(("POC 0 seeded maps", sao_ext_shards(torch, pic, dev, maps=maps)[0]))
    for what, cases in sets:
        sums = {}
        for label, args in cases:
            theirs = torch.full(args[1].shape, -1, dtype=torch.int32, device=dev)
            versus_row(torch, other, "vtm_sao_apply_ext", f"1080p {what} VER {label}",
                       lambda: other_call(ext_fn, *args, theirs),
                       lambda: SK.sao_apply_ext_cuda(*args), theirs, args[:5], sums)
        versus_sums(sums, f"8 VER shards, {what}")
    sums = {}
    planes, (_, cb, cr), bd = sao_chain_inputs(torch, pic, dev)
    if len(planes) < 3:
        # chroma without SAO in this picture: its planes with seeded maps
        rng = np.random.default_rng(29)
        planes += [(f"{label}, seeded maps", p, seeded_sao_maps(torch, p, rng))
                   for label, p in (("Cb", cb), ("Cr", cr))
                   if not any(q[0] == label for q in planes)]
    for label, p, maps in planes:
        theirs = torch.full_like(p, -1)
        versus_row(torch, other, "vtm_sao_apply", f"1080p POC 0 {label}",
                   lambda: other_call(plane_fn, p, *maps, bd, theirs),
                   lambda: SK.sao_apply_cuda(p, *maps, bit_depth=bd), theirs, (p, maps),
                   sums)
    versus_sums(sums, "Y + Cb + Cr")


def launch_through(torch, KN, fns: dict, call):
    """call(), with its KN.launch of each entry in `fns` sent to that
    function (another build's, from other_entries) on the device's current
    stream; returns what call() returns.  The other build gets the tables
    this checkout's wrappers pack."""
    real = KN.launch

    def launch(name, device, *args):
        with torch.cuda.device(device):
            err = fns[name](*args, torch.cuda.current_stream(device).cuda_stream)
        if err:
            raise RuntimeError(f"the other build's {name}: CUDA error {err}")

    KN.launch = launch
    try:
        return call()
    finally:
        KN.launch = real


def record_live_halo(torch, KN) -> list:
    """The halo calls of the live decode mesh (codec_mesh(4, gop=2), lanes
    sharing the card) on LIVE_STREAMS, recorded by LiveRecorder: (kernel,
    shape, cuda fn, plain fn, args, kwargs, launches) each."""
    from vtm_tpu_torch.decoder.declib import Decoder
    from vtm_tpu_torch.ops import alf_kernel as AK
    from vtm_tpu_torch.ops import deblock_kernel as DK
    from vtm_tpu_torch.ops import mc_kernel as MK
    from vtm_tpu_torch.ops import sao_kernel as SK
    from vtm_tpu_torch.parallel import mesh as MS
    from vtm_tpu_torch.parallel import pic_shard as PS

    mesh = MS.codec_mesh(4, gop=2, device="cuda")
    rec = LiveRecorder(torch, KN, dict(DK=DK, SK=SK, AK=AK, MS=MS, MK=MK, PS=PS))
    try:
        for name in LIVE_STREAMS:
            with MS.decode_mesh_ctx(mesh):
                dec = Decoder(device="cuda")
                pics = dec.decode_stream(read_stream(name))
            if not all(hr.ok for hr in dec.hash_results) or len(dec.hash_results) != len(pics):
                raise AssertionError(f"live mesh {name}: a picture's hash failed")
    finally:
        rec.close()
    return [c for c in rec.calls if c[0] in HALO_ENTRIES]


def versus_halo(torch, KN, other: str) -> None:
    """vtm_halo_gather and vtm_halo_add_deltas against the build of another
    halo.cu (with its common.cuh) in `other`, in turns, both builds given
    the same lane tables (launch_through): phase 3's cases (halo_cases: the
    eight VER shards of 1080p POC 0 at h 8, h 1 pad 1, h 4 pad 4, the VER
    deltas' return, and the ring), then every halo call of the live decode
    mesh (record_live_halo), a row a call at its `live shard WxH`; a
    `versus sum` line a kernel for each set and live shard shape."""
    from vtm_tpu_torch.parallel import multichip as MCH

    _, fns = other_entries(KN, other, "halo.cu", HALO_ENTRIES)
    fns = dict(zip(HALO_ENTRIES, fns))
    for name, cfg in halo_config(KN).items():
        print(f"  launch shape {name}: {cfg}", flush=True)
    dev = torch.device("cuda")

    def row(kernel, label, fn, ins, sums):
        theirs = []

        def other_fn():
            theirs[:] = launch_through(torch, KN, fns, fn)
            return 0

        versus_row(torch, other, kernel, label, other_fn, fn, theirs, ins, sums)

    pic = MCH.capture_decode(HD_STREAM, "cuda")["pics"][0]
    sums = {}
    for c in halo_cases(torch, pic, dev):
        row(c["kernel"], c["label"], c["cuda"], c["ins"], sums)
    versus_sums(sums, "1080p POC 0: 8 VER shards at h 8, 1, 4, the delta return; the ring")
    by_shape = {}
    for i, (kernel, shape, real, _, args, kw, _) in enumerate(record_live_halo(torch, KN)):
        ins, _ = live_cost(kernel, args, kw)
        row(kernel, f"{shape} call {i}", partial(real, *args, **kw), ins,
            by_shape.setdefault(shape, {}))
    for shape, sums in sorted(by_shape.items()):
        versus_sums(sums, f"the live mesh's calls at {shape}")
    halo_crossover(torch, KN, other)


# (lanes, rows, len) of halo_crossover's seeded shards
CROSSOVER_SHARDS = ((2, 120, 104), (2, 240, 208), (2, 360, 312), (2, 480, 416),
                    (2, 600, 520), (2, 720, 624), (2, 1080, 960), (4, 540, 240),
                    (4, 1080, 480), (8, 1080, 240))


def halo_crossover(torch, KN, out_dir: str) -> None:
    """Where csrc/halo.cu's launches switch from the element kernels to the
    row kernels (HALO_ELEM_MAX output elements): this checkout's halo.cu
    built twice into `out_dir`, every launch forced to the row kernels and
    every launch forced to the element kernels, both held equal to this
    build and timed (device us) on seeded shards of growing size
    (CROSSOVER_SHARDS): the gather at h 8 and at h 1 pad 1, the delta
    return at h 8; a line a case with the output elements and this build's
    time."""
    from vtm_tpu_torch.parallel import mesh as MS

    src = os.path.relpath(os.path.join(KN.CSRC, "halo.cu"), out_dir)
    builds = {}
    for what, elem_max in (("rows", 0), ("elements", 1 << 30)):
        _, fns = other_entries(KN, out_dir, src, HALO_ENTRIES,
                               defines=(f"HALO_ELEM_MAX={elem_max}",), tag=f"halo_{what}")
        builds[what] = dict(zip(HALO_ENTRIES, fns))
    g = torch.Generator(device="cuda").manual_seed(5)

    def seeded(*shape):
        return torch.randint(-2**31, 2**31 - 1, shape, dtype=torch.int32, device="cuda",
                             generator=g)

    for n, rows, ln in CROSSOVER_SHARDS:
        xs = [seeded(rows, ln) for _ in range(n)]
        ds = [seeded(rows, ln + 16) for _ in range(n)]
        for label, elems, fn in (
                ("gather h 8", n * rows * (ln + 16), partial(MS.halo_gather_cuda, xs, 8)),
                ("gather h 1 pad 1", n * (rows + 2) * (ln + 2),
                 partial(MS.halo_gather_cuda, xs, 1, pad=1)),
                ("delta h 8", n * rows * ln, partial(MS.halo_add_deltas_cuda, xs, ds, 8))):
            want = fn()
            times = {}
            for what, fns in builds.items():
                call = partial(launch_through, torch, KN, fns, fn)
                if not all_equal(torch, call(), want):
                    raise AssertionError(f"halo crossover {what} build, {label}: outputs differ")
                ms, paced = device_ms(torch, call)
                if paced:
                    raise AssertionError(f"halo crossover timing {paced}")
                times[what] = ms * 1e3
            ms, paced = device_ms(torch, fn)
            if paced:
                raise AssertionError(f"halo crossover timing {paced}")
            print(f"halo crossover {n} lanes {rows}x{ln}, {label}: {elems} output elements, "
                  f"rows {times['rows']:.3f} us, elements {times['elements']:.3f} us, "
                  f"this build {ms * 1e3:.3f} us (outputs equal)", flush=True)


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
                    i32 = chk.last
                    s = chk.compare("vtm_inv_transform_s8", tag,
                                    lambda: TR.inv_transform_batch_s8_cuda(*args),
                                    lambda: TR.inv_transform_batch_s8_plain(*args),
                                    timed, ins=c, ops=4 * macs,
                                    peak=INT8_TC_OPS_PER_S, quiet=not timed)
                    if not (torch.equal(a, s) and torch.equal(a, plain)):
                        raise AssertionError(f"vtm_inv_transform != vtm_inv_transform_s8 [{tag}]")
                    if timed:
                        s8 = chk.last
                        t_b, t_o = s8["bytes"] / BYTES_PER_S, s8["ops"] / INT8_TC_OPS_PER_S
                        print(f"transform {tag}: vtm_inv_transform_s8 {s8['ms']:.6f} ms, "
                              f"vtm_inv_transform {i32['ms']:.6f} ms (device), s8 bound "
                              f"{max(t_b, t_o) * 1e3:.6f} ms "
                              f"({'bytes' if t_b >= t_o else 'operations'}; "
                              f"{100 * max(t_b, t_o) * 1e3 / s8['ms']:.2f} %), faster: "
                              f"{'vtm_inv_transform_s8' if s8['ms'] < i32['ms'] else 'vtm_inv_transform'}",
                              flush=True)
                    cases += 1
    print(f"inverse transforms: {cases} cases, vtm_inv_transform == "
          "vtm_inv_transform_s8 == plain on every one", flush=True)


def delta_shards(torch, pic: dict, dev, lanes: int = 8):
    """The vtm_deblock_luma_ver_delta calls of the sharded luma chain
    (pic_shard.make_sharded_luma_filters) over `lanes` width shards of a
    captured picture, as (label, pad, maps): the VER shards, each extended
    by its neighbours' 8 columns, then the HOR shards, the VER result
    (every lane's returned halo deltas added; from the plain deltas)
    transposed and edge-padded by 8 columns; also the VER-deblocked shards
    and the bit depth."""
    from vtm_tpu_torch.ops import deblock_kernel as DK
    from vtm_tpu_torch.ops import edge_pad
    from vtm_tpu_torch.parallel import pic_shard as PS

    x, dv, dh, *_ = PS.luma_chain_args(pic)
    bd = int(pic["bd"])
    devs = [dev] * lanes
    xs = PS._split_cols(PS._t(x), lanes, devs)
    dvs = zip(*(PS._split_cols(PS._t(m), lanes, devs) for m in dv))
    ver = [(f"VER shard {i} of {lanes}", e, m)
           for i, (e, m) in enumerate(zip(PS._halo_cols(xs, 8), dvs))]
    xs = PS.add_halo_deltas(xs, [DK.luma_ver_delta_plain(e, *m, bd) for _, e, m in ver], 8)
    dhs = zip(*(PS._split_cols(PS._t(m), lanes, devs, axis=0) for m in dh))
    hor = [(f"HOR shard {i} of {lanes}", edge_pad(v.T, 0, 8), m)
           for i, (v, m) in enumerate(zip(xs, dhs))]
    return ver + hor, xs, bd


def launch_floor(torch, chk: KernelCheck, name: str, label: str, fn) -> float:
    """Device ms of one launch: of a kernel on one tile, the floor any of
    its launches pays, whatever its size; of a plain copy of a shard, the
    floor of any launch that moves the shard's plane in and out.  Kept in
    chk.floors[label]."""
    ms, paced = device_ms(torch, fn)
    if paced:
        raise AssertionError(f"launch floor {name} {paced}")
    print(f"launch floor {name}: {label}, {ms:.6f} ms device", flush=True)
    chk.floors[label] = ms
    return ms


def check_shard_entries(torch, chk: KernelCheck, pic: dict, dev, lanes: int = 8):
    """The luma deblocking delta on the `lanes` VER and HOR width shards of
    a captured 1080p picture (delta_shards), the classifier on one shard as
    the sharded chain pads it, the extended-plane SAO on the VER shards,
    each with its neighbours' real halo (edge copies at the picture
    border), and the recon/SSE epilogue on two 1080p planes of 32x32
    blocks; timed, and the delta's and the classifier's launch floors."""
    import numpy as np

    from vtm_tpu_torch.ops import alf_kernel as AK
    from vtm_tpu_torch.ops import deblock_kernel as DK
    from vtm_tpu_torch.ops import sao_kernel as SK
    from vtm_tpu_torch.parallel import mesh as MS
    from vtm_tpu_torch.parallel import pic_shard as PS

    _, _, _, sao, alf, _ = PS.luma_chain_args(pic)
    shards, ver_xs, bd = delta_shards(torch, pic, dev, lanes)
    for label, e, maps in shards:
        chk.compare("vtm_deblock_luma_ver_delta", f"1080p POC 0 {label}",
                    lambda: DK.luma_ver_delta_cuda(e, *maps, bd),
                    lambda: DK.luma_ver_delta_plain(e, *maps, bd), timed=True,
                    ins=(e, maps), ops=10 * e.numel(), shape="shard")
    # floors: an empty kernel, a copy of a VER and of a HOR shard's plane,
    # and one tile of the delta (4 x 128 samples)
    launch_floor(torch, chk, "empty kernel", "torch.cuda._sleep(0)",
                 lambda: torch.cuda._sleep(0))
    for label, e, _ in (shards[0], shards[lanes]):
        dst = torch.empty_like(e)
        launch_floor(torch, chk, "shard copy", f"torch copy_ of {label}'s plane "
                     f"{tuple(e.shape)} int32, {2 * e.numel() * 4} bytes",
                     lambda: dst.copy_(e))
    e, maps = shards[0][1:]
    tile = (e[:4, :128].contiguous(), [m[:1, :28].contiguous() for m in maps])
    launch_floor(torch, chk, "vtm_deblock_luma_ver_delta", "one 4 x 128 tile of VER shard 0",
                 lambda: DK.luma_ver_delta_cuda(tile[0], *tile[1], bd))
    if alf is not None:
        # shard 1 after VER, with 4-column halos and 4 edge rows: the
        # classifier's input on the sharded chain (there after HOR and SAO)
        rows = [PS._t(r).to(dev) for r in alf[5:12]]
        p4 = PS._halo_cols(ver_xs, 4, pad=AK.PAD)[1]
        chk.compare("vtm_alf_classify",
                    f"1080p POC 0 shard 1 of {lanes}, {p4.shape[1]} columns",
                    lambda: AK.classify_picture_cuda(p4, *rows, bit_depth=bd),
                    lambda: AK.classify_picture_plain(p4, *rows, bit_depth=bd), timed=True,
                    ins=(p4, rows), ops=12 * (p4.shape[0] - 8) * (p4.shape[1] - 8),
                    shape="shard")
        tile = p4[:40, :136].contiguous()
        small = [r[:18] for r in rows[:4]] + [r[:8] for r in rows[4:]]
        launch_floor(torch, chk, "vtm_alf_classify", "one tile, 8 x 32 4x4 blocks",
                     lambda: AK.classify_picture_cuda(tile, *small, bit_depth=bd))
        # its luma filter, on the shard's classes (the sharded chain's
        # vtm_alf_filter launch)
        cls, tr = AK.classify_picture_cuda(p4, *rows, bit_depth=bd)
        ctu = PS._split_cols(PS._t(alf[2]), lanes, [dev] * lanes)[1]
        cperm, lperm = (PS._t(a).to(dev) for a in alf[:2])
        gather = (ctu.long(), cls.long(), tr.long())
        coef, clip = cperm[gather], lperm[gather]
        o_rows, near = (PS._t(a).to(dev) for a in alf[3:5])
        chk.compare("vtm_alf_filter",
                    f"1080p POC 0 shard 1 of {lanes}, {p4.shape[1]} columns, luma",
                    lambda: AK.alf_filter_cuda(p4, coef, clip, o_rows, near,
                                               taps=AK.LUMA_TAPS, bit_depth=bd),
                    lambda: AK.alf_filter_plain(p4, coef, clip, o_rows, near,
                                                taps=AK.LUMA_TAPS, bit_depth=bd),
                    timed=True, ins=(p4, coef, clip, o_rows, near),
                    ops=48 * (p4.shape[0] - 8) * (p4.shape[1] - 8), shape="shard")
    if sao is not None:
        cases, xs = sao_ext_shards(torch, pic, dev, lanes)
        for label, args in cases:
            chk.compare("vtm_sao_apply_ext", f"1080p POC 0 {label}",
                        lambda: SK.sao_apply_ext_cuda(*args),
                        lambda: SK.sao_apply_ext_plain(*args), timed=True,
                        ins=args[:5], ops=8 * args[1].numel(), shape="shard")
    rng = np.random.default_rng(23)
    shape = (2, 2040, 32, 32)
    resid, pred, orig = (torch.from_numpy(a.astype(np.int32)).to(dev) for a in (
        rng.integers(-300, 300, shape), rng.integers(0, 256, shape),
        rng.integers(0, 256, shape)))
    chk.compare("vtm_recon_sse", "2 x 2040 32x32 blocks",
                lambda: MS.recon_sse_cuda(resid, pred, orig),
                lambda: MS.recon_sse_plain(resid, pred, orig), timed=True,
                ins=(resid, pred, orig), ops=6 * resid.numel())


def delta_bytes(shards, h: int) -> Bytes:
    """Bytes of the deltas that vtm_halo_add_deltas reads: the centre of
    each lane's delta tile and the h columns its neighbours computed for
    each of its inner edges."""
    rows, size = shards[0].shape[0], shards[0].element_size()
    centre = sum(x.numel() for x in shards)
    return Bytes((centre + 2 * (len(shards) - 1) * h * rows) * size)


def all_equal(torch, got, want) -> bool:
    return all(torch.equal(a, b) for a, b in zip(got, want, strict=True))


def halo_cases(torch, pic: dict, dev, lanes: int = 8) -> list:
    """The two halo kernels' phase-3 cases on the `lanes` VER shards of a
    captured picture's luma (as the chain's deblocking sees it): dicts of
    kernel, label, cuda and plain (calls of no arguments), ins (what the
    bytes bound counts besides the output) and shape.  The gather with h 8
    (the deblocking), 1 with one edge row (SAO) and 4 with four (ALF), and
    the return of the VER deltas, at shape "shard" (the dry run's sharded
    luma chain); last the ring of mesh.halo_exchange on the shards
    transposed, 8 rows a side (no path launches it)."""
    from vtm_tpu_torch.ops import alf_kernel as AK
    from vtm_tpu_torch.ops import deblock_kernel as DK
    from vtm_tpu_torch.parallel import mesh as MS
    from vtm_tpu_torch.parallel import pic_shard as PS

    x, dv, *_ = PS.luma_chain_args(pic)
    bd = int(pic["bd"])
    devs = [dev] * lanes
    xs = PS._split_cols(PS._t(x), lanes, devs)
    tag = f"{lanes} VER shards {tuple(xs[0].shape)} of 1080p POC 0"
    cases = []
    for h, pad, what in ((8, 0, "deblocking"), (1, 1, "SAO"), (4, AK.PAD, "ALF")):
        kw = dict(h=h, axis=1, wrap=False, pad=pad)
        cases.append(dict(kernel="vtm_halo_gather", label=f"{tag}, h {h}, pad {pad} ({what})",
                          cuda=partial(MS.halo_gather_cuda, xs, **kw),
                          plain=partial(MS.halo_gather_plain, xs, **kw), ins=(xs,),
                          shape="shard"))
    dvs = zip(*(PS._split_cols(PS._t(m), lanes, devs) for m in dv))
    acc = [DK.luma_ver_delta_cuda(e, *m, bd)
           for e, m in zip(MS.halo_gather_cuda(xs, 8), dvs)]
    cases.append(dict(kernel="vtm_halo_add_deltas", label=f"{tag}, h 8 (the VER deltas' return)",
                      cuda=partial(MS.halo_add_deltas_cuda, xs, acc, 8),
                      plain=partial(MS.halo_add_deltas_plain, xs, acc, 8),
                      ins=(xs, delta_bytes(xs, 8)), shape="shard"))
    shards = [t.T.contiguous() for t in xs]
    kw = dict(h=8, axis=0, wrap=True)
    cases.append(dict(kernel="vtm_halo_gather",
                      label=f"{lanes} shards {tuple(shards[0].shape)} transposed, ring, 8 rows "
                            "a side (mesh.halo_exchange)",
                      cuda=partial(MS.halo_gather_cuda, shards, **kw),
                      plain=partial(MS.halo_gather_plain, shards, **kw), ins=(shards,),
                      shape=None))
    return cases


def check_halo_kernels(torch, chk: KernelCheck, pic: dict, dev, lanes: int = 8) -> None:
    """The two halo kernels against their plain versions on halo_cases,
    timed; each row's library column is the torch.cat (+ edge_pad, or
    slices and +=) calls they replace, the plain versions, timed the same
    way.  The ring is also held to the neighbours' rows and printed beside
    its bytes bound.  A gather's bytes bound counts each shard read once and
    each extended shard written once: a halo strip lies inside a
    neighbour's shard, already counted.  The delta return's counts its
    neighbours' edge deltas besides (delta_bytes), which lie outside the
    centres it reads."""
    from vtm_tpu_torch.parallel import mesh as MS

    cases = halo_cases(torch, pic, dev, lanes)
    # the ring: each lane's transposed shard extended by 8 rows of each
    # neighbour, the wrap at the ends
    halo = 8
    shards = cases[-1]["ins"][0]
    for i, (t, e) in enumerate(zip(shards, MS.halo_exchange(shards, halo))):
        want = torch.cat([shards[i - 1][-halo:], t, shards[(i + 1) % lanes][:halo]])
        if not torch.equal(e, want):
            raise AssertionError(f"halo_exchange: lane {i} != its neighbours' rows")
    for c in cases:
        chk.compare(c["kernel"], c["label"], c["cuda"], c["plain"], timed=True,
                    ins=c["ins"], shape=c["shape"],
                    library=(c["plain"], lambda a, b: all_equal(torch, a, b)))
    last = chk.last
    bound = last["bytes"] / BYTES_PER_S * 1e3
    floors = "; ".join(f"{k} {v:.6f} ms" for k, v in chk.floors.items()
                       if k.startswith(("torch.cuda._sleep", "torch copy_")))
    print(f"halo_exchange [{lanes} lanes, shards {tuple(shards[0].shape)} transposed, "
          f"{halo} halo rows a side]: equal to the neighbours' rows; {last['ms']:.6f} ms "
          f"device (one vtm_halo_gather launch), {last['bytes']} bytes (shards read "
          f"once, extended shards written once), bound {bound:.6f} ms "
          f"(bytes), {100 * bound / last['ms']:.2f} % of bound; shard floors: {floors}",
          flush=True)


def halo_config(KN) -> dict:
    """The launch shape of csrc/halo.cu's kernels on the current card (the
    row kernels and the element kernels of small launches;
    vtm_halo_config: threads, static shared bytes, registers, resident CTAs
    an SM, local bytes), as DK.kernel_config gives the deblocking tiles'."""
    import ctypes

    from vtm_tpu_torch.ops.deblock_kernel import CONFIG_FIELDS

    fn = KN.library().vtm_halo_config
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    n = len(CONFIG_FIELDS)
    buf = (ctypes.c_int * (n * len(HALO_KERNELS)))()
    err = fn(ctypes.cast(buf, ctypes.c_void_p))
    if err:
        raise RuntimeError(f"vtm_halo_config: CUDA error {err}")
    return {k: dict(zip(CONFIG_FIELDS, buf[i * n:(i + 1) * n]))
            for i, k in enumerate(HALO_KERNELS)}


def mesh_inputs(torch, dev) -> dict:
    """The inputs of phase 6's sharded MC and reconstruction stages (their
    shard-shape kernel cases in phase 3 take them too): the decodes that
    capture ra_full_small208_qp32 (`small_cap`) and the flagship RA stream's
    MC slice (`ra`), a 1080p-sized seeded luma MC batch (`seeded`, with its
    plain result), and two 1080p luma planes of 32x32 blocks for the
    reconstruction step (`coeff`, `pred`, `orig` as numpy (2, 2040, 32,
    32), with the plain recon and SSE they are held to)."""
    import numpy as np

    from vtm_tpu_torch import testing as T
    from vtm_tpu_torch.ops import mc_kernel as MK
    from vtm_tpu_torch.ops import transform as TR
    from vtm_tpu_torch.parallel import mesh as MS
    from vtm_tpu_torch.parallel import multichip as MCH

    small_cap = MCH.capture_decode(MCH.STREAM, "cuda")
    ra = MCH.capture_decode(RA_STREAM, "cuda")["mc"]
    rng = np.random.default_rng(29)
    refs = np.stack([T.plane(rng, 1080, 1920, 8) for _ in range(4)])
    args = (refs,) + T.mc_tiles_case(rng, refs, 129_600, True, 8, cover=True)
    planes = [torch.from_numpy(p).to(dev) for p in refs]
    jobs = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in args[1:]]
    seeded = dict(args=args, taps=8, tile=4, bd=8,
                  out=MK.mc_tiles_plain(planes, *jobs, taps=8, tile=4, bd=8).cpu().numpy())
    shape = (2, 2040, 32, 32)
    coeff = rng.integers(-2048, 2048, size=shape).astype(np.int32)
    pred = rng.integers(0, 256, size=shape).astype(np.int32)
    orig = np.clip(pred + rng.integers(-20, 21, size=shape), 0, 255).astype(np.int32)
    c, p, o = (torch.from_numpy(a).to(dev) for a in (coeff, pred, orig))
    resid = TR.inv_transform_batch_plain(c.reshape(-1, 32, 32), 8).reshape(shape)
    want_recon, want_sse = MS.recon_sse_plain(resid, p, o)
    torch.cuda.synchronize()
    return dict(small_cap=small_cap, ra=ra, seeded=seeded, coeff=coeff, pred=pred,
                orig=orig, want_recon=want_recon.cpu(),
                want_sse=want_sse.to(torch.float32).cpu())


def check_mesh_batches(torch, chk: KernelCheck, mesh_in: dict, dev):
    """The multi-device path's MC and reconstruction kernels at the shapes
    its lanes launch them (shape "shard"), timed: vtm_mc_tiles on lane 0's
    share of each sharded MC batch (pic_shard.split_mc_jobs, as
    sharded_mc_tiles splits it: the 1080p-sized seeded batch and the RA
    slice on 1 and 4 lanes, the ra_full_small208_qp32 batch on the 1, 2
    and 8 lanes of its dry runs), and vtm_inv_transform and vtm_recon_sse on
    lane 0's slice of the (2, 2040, 32, 32) reconstruction step on 1 x 1
    lanes (4,080 blocks) and on 2 x 2 lanes (1,020 blocks); each case
    weighed as often as one run of its stage launches it."""
    from vtm_tpu_torch.ops import mc_kernel as MK
    from vtm_tpu_torch.ops import transform as TR
    from vtm_tpu_torch.parallel import mesh as MS
    from vtm_tpu_torch.parallel import multichip as MCH
    from vtm_tpu_torch.parallel import pic_shard as PS

    for label, mc, lane_counts in (("1080p seeded", mesh_in["seeded"], (1, 4)),
                                   (f"{RA_STREAM} slice", mesh_in["ra"], (1, 4)),
                                   (MCH.STREAM, mesh_in["small_cap"]["mc"], (1, 2, 8))):
        kw = dict(taps=mc["taps"], tile=mc["tile"], bd=mc["bd"])
        tile, taps = kw["tile"], kw["taps"]
        for n in lane_counts:
            refs, shares = PS.split_mc_jobs(mc, n)
            planes = [p.to(dev) for p in refs]
            jobs = [a.to(dev).contiguous() for a in shares[0]]
            nb = jobs[0].shape[0]
            read = mc_ref_bytes(planes, jobs, taps, tile)
            chk.compare("vtm_mc_tiles", f"{label}, lane 0 of {n}: {nb} luma tiles, "
                        f"{read} reference bytes reachable of {nbytes(planes)}",
                        lambda: MK.mc_tiles_cuda(planes, *jobs, **kw),
                        lambda: MK.mc_tiles_plain(planes, *jobs, **kw), timed=True,
                        ins=(read, jobs), ops=mc_ops(nb, taps, tile),
                        shape="shard", weight=n)
    c, p, o = (torch.from_numpy(mesh_in[k]).to(dev) for k in ("coeff", "pred", "orig"))
    for lanes, n, sl in (("1 x 1", 1, (slice(None), slice(None))),
                         ("2 x 2", 4, (slice(0, 1), slice(0, 1020)))):
        cl, pl, ol = (a[sl].contiguous() for a in (c, p, o))
        blocks = cl.reshape(-1, 32, 32)
        nb = blocks.shape[0]
        tag = f"lane 0 of sharded_recon_step on {lanes} lanes, {nb} 32x32 blocks"
        resid = chk.compare("vtm_inv_transform", tag,
                            lambda: TR.inv_transform_batch_cuda(blocks, 8),
                            lambda: TR.inv_transform_batch_plain(blocks, 8), timed=True,
                            ins=blocks, ops=nb * 32 * 32 * 64, shape="shard", weight=n)
        resid = resid.reshape(cl.shape)
        chk.compare("vtm_recon_sse", tag,
                    lambda: MS.recon_sse_cuda(resid, pl, ol),
                    lambda: MS.recon_sse_plain(resid, pl, ol), timed=True,
                    ins=(resid, pl, ol), ops=6 * resid.numel(), shape="shard", weight=n)


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
    what = {k: v for k, v in rep.items()
            if k not in per and k not in ("launches", "stage_launches")}
    print(f"dryrun_multichip {rep['stream']} {what}: " + "; ".join(parts)
          + f"; launches of one run of each stage {rep['launches']}", flush=True)


def mesh_path(torch, KN, hd_cap: dict, mesh_in: dict) -> dict:
    """The multi-device main path on lanes sharing the card; returns its
    launch counts, those of one run of each stage, by the shape its lanes
    work on: {"shard": the width-sharded luma chain, the sharded MC and the
    sharded reconstruction; a size_key a stream: the gop-batched full chain
    of its pictures, whose lanes take whole pictures}.  Its inputs (`mesh_in`: the decodes that
    capture the small208 and RA streams, the seeded MC batch, the
    reconstruction step's blocks, and the plain results the MC and recon
    stages are held to) were made before; the counts are zeroed here, and
    only the sharded calls and their one-lane runs follow.  Every lane is
    held to its picture's single-lane result; every stage runs REPEATS
    times (multichip.timed_runs, which asserts that each run launched what
    the first did), and its host seconds (inputs uploaded, result fetched)
    are printed as median, min and max beside the one-lane run's.  The
    runs exist for the seconds' spread, so one run of each stage is what
    the path launches; all launches of the phase must be REPEATS times
    those."""
    import numpy as np

    from vtm_tpu_torch.parallel import mesh as MS
    from vtm_tpu_torch.parallel import multichip as MCH
    from vtm_tpu_torch.parallel import pic_shard as PS

    small_cap, ra, seeded = (mesh_in[k] for k in ("small_cap", "ra", "seeded"))
    coeff, pred, orig = (mesh_in[k] for k in ("coeff", "pred", "orig"))
    want_recon, want_sse = mesh_in["want_recon"], mesh_in["want_sse"]
    shape = coeff.shape

    # ---- the path: sharded calls and their one-lane runs alone ----
    KN.reset_launch_counts()
    counts = {"shard": dict.fromkeys(KN.KERNELS, 0)}

    def count(launches: dict, at: str = "shard") -> dict:
        row = counts.setdefault(at, dict.fromkeys(KN.KERNELS, 0))
        for k, v in launches.items():
            row[k] += v
        return launches

    for stream, cap, cases in ((HD_STREAM, hd_cap, ((1, 1), (4, 2), (8, 8))),
                               (MCH.STREAM, small_cap, ((1, None), (2, None), (8, None)))):
        one, key = None, planes_key(cap["pics"][0]["planes"])
        for n, tile in cases:
            rep = MCH.dryrun_multichip(n, device="cuda", stream=stream, tile=tile,
                                       cap=cap, repeats=REPEATS)
            for stage, launches in rep["stage_launches"].items():
                count(launches, key if stage == "full_chain_s" else "shard")
            one = one or rep
            show_dryrun(rep, one)
    # the MC job axis over 4 lanes: a 1080p-sized seeded batch, a slice batch
    # of the flagship RA stream
    for label, mc in (("1080p seeded, 129600 luma tiles", seeded),
                      (f"{RA_STREAM} slice, {ra['out'].shape[0]} luma tiles", ra)):
        one = None
        for n in (1, 4):
            mesh = MS.codec_mesh(n, device="cuda")
            got, secs, runs = MCH.timed_runs(
                lambda: PS.sharded_mc_tiles(mesh, mc).cpu().numpy(), REPEATS)
            if not np.array_equal(got, mc["out"]):
                raise AssertionError(f"sharded MC mismatch ({label}, {n} lanes)")
            one = one or secs
            print(f"sharded_mc_tiles [{label}] on {n} lanes: equal to the single-lane "
                  f"result, {spread(secs)}, "
                  f"{statistics.median(secs) / statistics.median(one):.4f}x one lane; "
                  f"launches of one run {count(runs)}", flush=True)
    # the sharded reconstruction step, against the plain transform and recon
    one = None
    for n in (1, 4):
        mesh = MS.codec_mesh(n, gop=min(n, 2), device="cuda")
        (recon, sse), secs, runs = MCH.timed_runs(
            lambda: tuple(t.cpu() for t in MS.sharded_recon_step(mesh, coeff, pred, orig)),
            REPEATS)
        if not (torch.equal(recon, want_recon) and torch.equal(sse, want_sse)):
            raise AssertionError(f"sharded_recon_step on {n} lanes != the plain result")
        one = one or secs
        print(f"sharded_recon_step {shape} on {mesh.gop} x {mesh.tile} lanes: equal to "
              f"the plain result, SSE {float(sse[0])}, {spread(secs)}, "
              f"{statistics.median(secs) / statistics.median(one):.4f}x one lane; "
              f"launches of one run {count(runs)}", flush=True)
    total = KN.launch_counts()
    if any(total[k] != REPEATS * sum(c[k] for c in counts.values()) for k in total):
        raise AssertionError(f"the phase launched {total}, not {REPEATS} x one run "
                             f"of each stage {counts}")
    print(f"launches, all {REPEATS} runs of each stage: {total}", flush=True)
    return counts


class LiveRecorder:
    """Records, while phase 6's live decode mesh runs, every call of the
    kernel wrappers its sharded path launches (the luma chain's inside
    pic_shard.luma_picture, every vtm_mc_tiles): the wrapper, its plain
    version, a copy of its arguments, its launches, and the shape it ran at
    (`live shard WxH`: a lane's shard of a picture split over the 'tile'
    lanes; `live MC lane share <stream>`: a lane's share of that stream's
    MC batches), so that each call is later held to its plain version and
    timed at that shape.  Other launches (the chroma stages on the home
    lane, DMVR, BDOF) run at whole pictures and are not recorded."""

    SHARD = (("DK", "luma_ver_delta", "vtm_deblock_luma_ver_delta"),
             ("SK", "sao_apply_ext", "vtm_sao_apply_ext"),
             ("AK", "classify_picture", "vtm_alf_classify"),
             ("AK", "alf_filter", "vtm_alf_filter"),
             ("MS", "halo_gather", "vtm_halo_gather"),
             ("MS", "halo_add_deltas", "vtm_halo_add_deltas"))

    def __init__(self, torch, KN, modules: dict):
        self.torch, self.KN = torch, KN
        self.calls = []  # (kernel, shape, cuda fn, plain fn, args, kwargs, launches)
        self.shard = None  # shape of the luma_picture call running, if any
        self.stream = None  # the stream being decoded
        self._undo = []
        for mod, name, kernel in self.SHARD:
            self._wrap(modules[mod], name, kernel, shard=True)
        self._wrap(modules["MK"], "mc_tiles", "vtm_mc_tiles", shard=False)
        PS = modules["PS"]
        real = PS.luma_picture

        def luma_picture(lanes, home, x, *args, **kw):
            self.shard = f"live shard {x.shape[1] // len(lanes)}x{x.shape[0]}"
            try:
                return real(lanes, home, x, *args, **kw)
            finally:
                self.shard = None

        PS.luma_picture = luma_picture
        self._undo.append((PS, "luma_picture", real))

    def _wrap(self, mod, name: str, kernel: str, shard: bool) -> None:
        real, plain = getattr(mod, f"{name}_cuda"), getattr(mod, f"{name}_plain")

        def rec(*args, **kw):
            shape = self.shard if shard else (
                None if self.stream is None else f"live MC lane share {self.stream}")
            if shape is None:
                return real(*args, **kw)
            before = self.KN.launch_counts()[kernel]
            out = real(*args, **kw)
            launched = self.KN.launch_counts()[kernel] - before
            kw = {k: v for k, v in kw.items() if k != "out"}
            self.calls.append((kernel, shape, real, plain, self._copy(args), kw, launched))
            return out

        setattr(mod, f"{name}_cuda", rec)
        self._undo.append((mod, f"{name}_cuda", real))

    def _copy(self, a):
        if isinstance(a, (list, tuple)):
            return type(a)(self._copy(x) for x in a)
        return a.clone() if self.torch.is_tensor(a) else a

    def close(self) -> None:
        for mod, name, real in reversed(self._undo):
            setattr(mod, name, real)

    def by_shape(self) -> dict:
        """{shape: {kernel: launches}} of the recorded calls."""
        out = {}
        for kernel, shape, *_, launched in self.calls:
            row = out.setdefault(shape, {})
            row[kernel] = row.get(kernel, 0) + launched
        return out


def live_cost(kernel: str, args, kw):
    """(ins, ops) of one recorded call of the live mesh, counted as phase 3
    counts the same kernel's cases."""
    if kernel == "vtm_deblock_luma_ver_delta":
        return (args[0], args[1:8]), 10 * args[0].numel()
    if kernel == "vtm_sao_apply_ext":
        return args[:5], 8 * args[1].numel()
    if kernel == "vtm_alf_classify":
        p4 = args[0]
        return (p4, args[1:]), 12 * (p4.shape[0] - 8) * (p4.shape[1] - 8)
    if kernel == "vtm_alf_filter":
        p4 = args[0]
        return args[:5], 48 * (p4.shape[0] - 8) * (p4.shape[1] - 8)
    if kernel == "vtm_halo_gather":
        return (args[0],), 0
    if kernel == "vtm_halo_add_deltas":
        return (args[0], delta_bytes(args[0], args[2])), 0
    planes, jobs = args[0], args[1:8]
    return ((mc_ref_bytes(planes, jobs, kw["taps"], kw["tile"]), jobs),
            mc_ops(jobs[0].shape[0], kw["taps"], kw["tile"]))


def live_mesh(torch, KN, chk: KernelCheck, mesh_off: dict) -> dict:
    """The live decode mesh: Decoder(device="cuda") under decode_mesh_ctx on
    codec_mesh(4, gop=2) (2 x 2 lanes sharing the card), each of
    LIVE_STREAMS decoded once: every picture hash-exact and its planes equal
    to phase 4's mesh-off decode, s/picture beside mesh-off, the route each
    picture's chain took (mesh.routes), and the LIVE_KERNELS launched.
    Counts are zeroed here; returns the launches by shape ({shape: {kernel:
    n}}): the recorded sharded calls at their `live ...` shapes (each then
    held to its plain version and timed there, after the counts are read),
    every other launch at its stream's pictures' size_key."""
    import numpy as np

    from vtm_tpu_torch.decoder.declib import Decoder
    from vtm_tpu_torch.ops import alf_kernel as AK
    from vtm_tpu_torch.ops import deblock_kernel as DK
    from vtm_tpu_torch.ops import mc_kernel as MK
    from vtm_tpu_torch.ops import sao_kernel as SK
    from vtm_tpu_torch.parallel import mesh as MS
    from vtm_tpu_torch.parallel import pic_shard as PS

    mesh = MS.codec_mesh(4, gop=2, device="cuda")
    rec = LiveRecorder(torch, KN, dict(DK=DK, SK=SK, AK=AK, MS=MS, MK=MK, PS=PS))
    by_shape = {}
    KN.reset_launch_counts()
    try:
        for name in LIVE_STREAMS:
            planes_off, s_off = mesh_off[name]
            mesh.routes.clear()
            n_rec = len(rec.calls)
            before = KN.launch_counts()
            rec.stream = name
            t0 = time.perf_counter()
            with MS.decode_mesh_ctx(mesh):
                dec = Decoder(device="cuda")
                pics = dec.decode_stream(read_stream(name))
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            rec.stream = None
            after = KN.launch_counts()
            if not pics or len(dec.hash_results) != len(pics):
                raise AssertionError(f"live mesh {name}: {len(pics)} pictures, "
                                     f"{len(dec.hash_results)} hashes")
            bad = [hr.poc for hr in dec.hash_results if not hr.ok]
            if bad:
                raise AssertionError(f"live mesh {name}: hash mismatch at POC {bad}")
            got = [[np.asarray(p) for p in pic.planes] for pic in pics]
            if len(got) != len(planes_off) or not all(
                    np.array_equal(a, b) for g, w in zip(got, planes_off)
                    for a, b in zip(g, w, strict=True)):
                raise AssertionError(f"live mesh {name}: planes differ from the "
                                     "mesh-off decode")
            launched = {k: after[k] - before[k] for k in after}
            recorded = {}
            for kernel, _, _, _, _, _, n in rec.calls[n_rec:]:
                recorded[kernel] = recorded.get(kernel, 0) + n
            key = planes_key(got[0])
            attribute(by_shape, key, {k: v - recorded.get(k, 0) for k, v in launched.items()})
            routes = {}
            for r in mesh.routes:
                routes[r["route"]] = routes.get(r["route"], 0) + 1
            per_pic = "; ".join(f"{i}: {r['route']} ({r['lanes']} lane"
                                f"{'s' if r['lanes'] > 1 else ''})"
                                for i, r in enumerate(mesh.routes))
            print(f"live mesh {name} ({key}) on {mesh.gop} x {mesh.tile} lanes of "
                  f"{sorted({str(d) for d in mesh.devices})}: {len(pics)} pictures, hashes "
                  f"OK, planes equal to mesh-off; {dt / len(pics):.6f} s/picture mesh on, "
                  f"{s_off:.6f} s/picture mesh off ({dt / len(pics) / s_off:.4f}x); "
                  f"chain routes {routes or 'none (no loop filter)'}"
                  f"{' [' + per_pic + ']' if per_pic else ''}; "
                  f"launches { {k: v for k, v in launched.items() if v} }", flush=True)
    finally:
        rec.close()
    total = KN.launch_counts()
    for shape, launched in rec.by_shape().items():
        attribute(by_shape, shape, launched)
    check_attributed(by_shape, total, "the live decode mesh")
    idle = [k for k in LIVE_KERNELS if total[k] == 0]
    if idle:
        raise AssertionError(f"the live decode mesh did not launch {idle}")
    print(f"launches, live decode mesh: { {k: v for k, v in total.items() if v} }",
          flush=True)
    # every recorded call against its plain version, timed at its shape
    t0 = time.perf_counter()
    sums = {}
    for i, (kernel, shape, real, plain, args, kw, n) in enumerate(rec.calls):
        ins, ops = live_cost(kernel, args, kw)
        # the halo rows' library column: the torch calls they replaced
        library = ((lambda: plain(*args, **kw), lambda a, b: all_equal(torch, a, b))
                   if kernel.startswith("vtm_halo") else None)
        chk.compare(kernel, f"{shape} call {i}", lambda: real(*args, **kw),
                    lambda: plain(*args, **kw), timed=True, ins=ins, ops=ops,
                    quiet=True, shape=shape, weight=n, library=library)
        row = sums.setdefault((shape, kernel), [0, 0.0, 0.0])
        row[0] += 1
        row[1] += chk.last["ms"]
        row[2] += max(chk.last["bytes"] / BYTES_PER_S, ops / chk.rows[kernel]["peak"]) * 1e3
    for (shape, kernel), (n, ms, bound) in sorted(sums.items()):
        print(f"{kernel} [{shape}]: {n} recorded calls equal to the plain version, "
              f"{ms:.6f} ms device in all, bound {bound:.6f} ms", flush=True)
    print(f"live mesh calls checked and timed in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return by_shape


def encode_small(torch, KN, Decoder, IntraEncoder, name: str, kw: dict) -> dict:
    """One 208x120 picture on the card and on the CPU: identical bytes, and
    the card's stream decodes hash-exact (on the card) to the encoder's
    reconstruction.  Returns the launches of the card's encode alone and
    those of the decode of its stream."""
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
    dec = check_own_decode(KN, Decoder, name, bits, enc)
    enc_l = {k: after[k] - before[k] for k in after if after[k] > before[k]}
    print(f"encode {name} {kw}: {len(bits)} bytes, identical on cuda and cpu, "
          f"decoded hash-exact; {dt:.4f} s on cuda; launches: encode {enc_l}, "
          f"decode of its stream { {k: v for k, v in dec.items() if v} }", flush=True)
    return {k: after[k] - before[k] for k in after}, dec


def check_own_decode(KN, Decoder, name: str, bits: bytes, enc, n_frames: int = 1) -> dict:
    """The port's decoder on the card verifies the hash of each of the
    stream's `n_frames` pictures, and the picture the encoder `enc` coded
    last equals its reconstruction.  Returns the decode's launches."""
    import numpy as np

    before = KN.launch_counts()
    dec = Decoder(device="cuda")
    pics = dec.decode_stream(bits)
    after = KN.launch_counts()
    if len(pics) != n_frames or len(dec.hash_results) != n_frames \
            or not all(hr.ok for hr in dec.hash_results):
        raise AssertionError(f"encode {name}: the port's decoder does not verify "
                             "every picture's hash")
    last = next(p for p in pics if p.poc == enc.dcs.sh.poc)
    if not all(np.array_equal(p, r) for p, r in zip(last.planes, enc.last_recon)):
        raise AssertionError(f"encode {name}: decoded picture != encoder recon")
    return {k: after[k] - before[k] for k in after}


@contextlib.contextmanager
def encode_stages(torch):
    """Times the stages of the encodes run inside it, on the host's clock:
    the wait for FrameRMD's results (the one fetch of the reductions, not
    the cached lookups after it), the deblocking stage, the SAO and ALF stage
    (searches, the device filters, the slice rewrite) and the MMVD and GEO
    preselection; and on the device timeline (CUDA events) FrameRMD's span
    (uploads, kernels and the gaps while the host prepares the next class)
    and each preselection MC call's span (its kernel and the host's issue of
    it).  Yields the dict of readings."""
    from vtm_tpu_torch.encoder import enc_lib as EL
    from vtm_tpu_torch.encoder import rmd as RMD
    from vtm_tpu_torch.ops import deblock as DBP
    from vtm_tpu_torch.ops import mc_kernel as MK

    spans = {"rmd_events": [], "rmd_wait": 0.0, "rmd_calls": 0, "deblock": 0.0,
             "sao_alf": 0.0, "presel": 0.0, "mc_events": []}
    real_rmd = RMD.FrameRMD

    class TimedFrameRMD(real_rmd):
        def __init__(self, *args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            super().__init__(*args, **kw)
            end.record()
            spans["rmd_events"].append((start, end))

        def _force_reduced(self):
            # every stats() call comes here; only the first fetches
            spans["rmd_calls"] += 1
            if self._stats is not None:
                return self._stats
            t0 = time.perf_counter()
            out = super()._force_reduced()
            spans["rmd_wait"] += time.perf_counter() - t0
            return out

    def timed(key, fn):
        def call(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                spans[key] += time.perf_counter() - t0
        return call

    real_mc = MK.mc_tiles_pair

    def mc_span(*args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = real_mc(*args, **kw)
        end.record()
        spans["mc_events"].append((start, end))
        return out

    patches = [(RMD, "FrameRMD", TimedFrameRMD),
               (DBP, "deblock_picture", timed("deblock", DBP.deblock_picture)),
               (EL.IntraEncoder, "_sao_and_rewrite",
                timed("sao_alf", EL.IntraEncoder._sao_and_rewrite)),
               (EL.InterEncoder, "_preselect_mmvd",
                timed("presel", EL.InterEncoder._preselect_mmvd)),
               (EL.InterEncoder, "_preselect_geo",
                timed("presel", EL.InterEncoder._preselect_geo)),
               (MK, "mc_tiles_pair", mc_span)]
    reals = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    for obj, name, fn in patches:
        setattr(obj, name, fn)
    try:
        yield spans
    finally:
        for obj, name, fn in reals:
            setattr(obj, name, fn)
        torch.cuda.synchronize()
        spans["rmd_ms"] = sum(a.elapsed_time(b) for a, b in spans["rmd_events"])
        spans["mc_ms"] = sum(a.elapsed_time(b) for a, b in spans["mc_events"])


def encode_hd(torch, KN, Decoder, IntraEncoder):
    """One 1920x1080 picture (mirror-tiled bq416) at QP 37 with bench.py's
    configuration on the card; decoded hash-exact by the port.  Prints
    s/picture and its split (encode_stages): the FrameRMD wait, the
    deblocking stage, the rest (host RD search, CABAC); and FrameRMD's span
    on the device timeline.  Returns the launches of the encode alone and
    those of the decode of its stream."""
    from vtm_tpu_torch import testing as T
    from vtm_tpu_torch.encoder.enc_lib import EncoderConfig

    frames = [T.hd_source()]
    before = KN.launch_counts()
    with encode_stages(torch) as spans:
        t0 = time.perf_counter()
        enc = IntraEncoder(EncoderConfig(width=1920, height=1080, qp=37),
                           device="cuda")
        bits = enc.encode(frames)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    after = KN.launch_counts()
    dec = check_own_decode(KN, Decoder, "hd_source 1920x1080", bits, enc)
    rest = dt - spans["rmd_wait"] - spans["deblock"]
    print(f"encode 1920x1080 (bq416 mirror-tiled) QP 37: {len(bits)} bytes, "
          f"decoded hash-exact; {dt:.4f} s/picture = FrameRMD wait "
          f"{spans['rmd_wait']:.4f} s (its one fetch of the reductions; "
          f"{spans['rmd_calls']} stats lookups in all) + deblock "
          f"{spans['deblock']:.4f} s + host RD and CABAC {rest:.4f} s; FrameRMD "
          f"span on the device timeline {spans['rmd_ms']:.4f} ms (CUDA events: uploads, "
          f"kernels, host gaps)", flush=True)
    return {k: after[k] - before[k] for k in after}, dec


@contextlib.contextmanager
def cpu_twin(case):
    """The device="cpu" encode of an RA_ENC_* case in a process of its own
    (one torch thread), so that it runs beside the card's: yields the
    process, which writes the stream to its stdout and its seconds to its
    stderr; the process is killed on the way out if it still runs."""
    code = ("import sys, time\n"
            "import torch\n"
            "torch.set_num_threads(1)\n"
            f"sys.path.insert(0, {ROOT!r})\n"
            "import chip_smoke as CS\n"
            "t0 = time.perf_counter()\n"
            f"bits = CS.ra_encoder({case!r}, 'cpu').encode(CS.ra_frames({case!r}))\n"
            "sys.stderr.write(f'{time.perf_counter() - t0}\\n')\n"
            "sys.stdout.buffer.write(bits)\n")
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        yield proc
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def encode_ra_small(torch, KN, Decoder, twin) -> dict:
    """(a) RA_ENC_SMALL on the card, and its CPU twin (`twin`, the process of
    cpu_twin, started ahead of phase 5): identical bytes, and the card's
    stream decoded hash-exact on the card.  Returns the launches of the
    card's encode alone and those of the decode of its stream."""
    src, w, h, n, gop, qp = RA_ENC_SMALL
    label = f"RA {src} {n} frames GOP {gop} QP {qp}"
    frames = ra_frames(RA_ENC_SMALL)
    before = KN.launch_counts()
    t0 = time.perf_counter()
    enc = ra_encoder(RA_ENC_SMALL, "cuda")
    bits = enc.encode(frames)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    after = KN.launch_counts()
    cpu_bits, err = twin.communicate(timeout=900)
    if twin.returncode != 0:
        raise AssertionError(f"encode {label} on the cpu failed: {err.decode()[-2000:]}")
    dt_cpu = float(err.decode().strip().splitlines()[-1])
    if bits != cpu_bits:
        raise AssertionError(f"encode {label}: cuda and cpu streams differ "
                             f"({len(bits)} vs {len(cpu_bits)} bytes)")
    dec_l = check_own_decode(KN, Decoder, label, bits, enc, n)
    launched = {k: after[k] - before[k] for k in after if after[k] > before[k]}
    print(f"encode {label} (sao, alf, RA's default tools): {len(bits)} bytes, "
          f"identical on cuda and cpu, decoded hash-exact on cuda; "
          f"{dt / n:.4f} s/picture on cuda, {dt_cpu / n:.4f} s/picture on cpu "
          f"(the two ran side by side, the cpu one in a process of its own); "
          f"launches of the encode {launched}", flush=True)
    return {k: after[k] - before[k] for k in after}, dec_l


def device_busy_ms(prof) -> float:
    """Device time of every kernel, copy and set the profiler saw (CUDA
    activity only: no host rows that repeat it), in ms."""
    total = 0.0
    for row in prof.key_averages():
        t = getattr(row, "self_device_time_total", None)
        total += t if t is not None else getattr(row, "self_cuda_time_total", 0)
    return total / 1e3


def encode_ra_d(torch, KN, Decoder) -> dict:
    """(b) RA_ENC_D on the card, under torch.profiler (CUDA activity only);
    its stream decoded hash-exact on the card.  Prints s/picture and its
    split (encode_stages: FrameRMD wait, deblocking, SAO and ALF,
    preselection, the rest being host RD search and CABAC), the
    preselection MC calls (count, summed device-timeline span, the kernel's
    own device time), the device's busy time and idle share of the encode's
    wall time, and the encode's own launches.  Returns those launches and
    those of the decode of its stream."""
    src, w, h, n, gop, qp = RA_ENC_D
    label = f"RA {src} {n} frames GOP {gop} QP {qp}"
    frames = ra_frames(RA_ENC_D)
    before = KN.launch_counts()
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
    with encode_stages(torch) as spans, prof:
        t0 = time.perf_counter()
        enc = ra_encoder(RA_ENC_D, "cuda")
        bits = enc.encode(frames)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    after = KN.launch_counts()
    dec_l = check_own_decode(KN, Decoder, label, bits, enc, n)
    launched = {k: after[k] - before[k] for k in after if after[k] > before[k]}
    busy = device_busy_ms(prof)
    mc_kernel = sum(getattr(r, "self_device_time_total", 0) for r in prof.key_averages()
                    if "mc_tiles_kernel" in r.key) / 1e3
    rest = dt - spans["rmd_wait"] - spans["deblock"] - spans["sao_alf"] - spans["presel"]
    types = " ".join(f"POC {r['poc']} {r['type']} {r['bits']} bits"
                     for r in enc.frame_log)
    print(f"encode {label} (sao, alf, RA's default tools): {len(bits)} bytes "
          f"({types}), decoded hash-exact on cuda; {dt / n:.4f} s/picture = "
          f"FrameRMD wait {spans['rmd_wait'] / n:.4f} s + deblock "
          f"{spans['deblock'] / n:.4f} s + SAO and ALF {spans['sao_alf'] / n:.4f} s "
          f"+ MMVD and GEO preselection {spans['presel'] / n:.4f} s + host RD and "
          f"CABAC {rest / n:.4f} s ({dt:.4f} s in all, under the profiler)", flush=True)
    print(f"encode {label} preselection: {len(spans['mc_events'])} MC calls "
          f"({launched.get('vtm_mc_tiles', 0)} vtm_mc_tiles launches), "
          f"{spans['mc_ms']:.4f} ms summed span on the device timeline (CUDA events "
          f"around each call: kernel and issue), {mc_kernel:.4f} ms of mc_tiles_kernel "
          f"device time (profiler), {spans['presel']:.4f} s on the host's clock",
          flush=True)
    if busy > 0:
        print(f"encode {label} device: {busy:.4f} ms busy (profiler: kernels, copies, "
              f"sets) of {dt * 1e3:.4f} ms wall, idle share {1 - busy / (dt * 1e3):.6f}; "
              f"FrameRMD span {spans['rmd_ms']:.4f} ms (CUDA events)", flush=True)
    else:
        print(f"encode {label} device: idle share not measured (the profiler saw no "
              "device time)", flush=True)
    print(f"encode {label} launches of the encode: {launched}; of the decode of its "
          f"stream: { {k: v for k, v in dec_l.items() if v} }", flush=True)
    return {k: after[k] - before[k] for k in after}, dec_l


def encode_gop(torch, KN, Decoder, case) -> tuple:
    """A GOP_CASES encode through vtm_tpu_torch.parallel.gop.encode_parallel
    on the card, with 2 workers and then with 1, each on the host's clock
    ending in torch.cuda.synchronize(): the two streams identical and
    decoded hash-exact on the card (every POC).  The workers' launches come
    back with their streams and are added to this process's counts; each
    run must launch every kernel of the case's list, and a deblocking, SAO
    or ALF kernel that the encodes leave out must be one the decode of the
    stream leaves out too.  Prints s/picture of both runs and their ratio
    beside the host's cores and torch's threads, and each run's host CPU
    seconds (this process and its finished children, the workers) over its
    wall seconds: the cores it kept busy.  Returns the launches of the two
    encodes, those of the decode, and the pictures' size_key."""
    import resource

    from vtm_tpu_torch import testing as T
    from vtm_tpu_torch.parallel.gop import encode_parallel

    label, mode, src, cfgk, n, seg, enc_kw, must = case
    w, h = cfgk["width"], cfgk["height"]
    frames = [T.hd_source(i) if src == "hd_source" else T.read_source(src, w, h, i)
              for i in range(n)]
    def cpu_s():
        kids = resource.getrusage(resource.RUSAGE_CHILDREN)
        return time.process_time() + kids.ru_utime + kids.ru_stime

    enc, secs, cores, streams, per_run = dict.fromkeys(KN.KERNELS, 0), {}, {}, [], {}
    for workers in (2, 1):
        before = KN.launch_counts()
        t0, c0 = time.perf_counter(), cpu_s()
        streams.append(encode_parallel(frames, dict(cfgk), mode=mode, segment_len=seg,
                                       workers=workers, enc_kwargs=enc_kw, device="cuda"))
        torch.cuda.synchronize()
        secs[workers] = time.perf_counter() - t0
        cores[workers] = (cpu_s() - c0) / secs[workers]
        after = KN.launch_counts()
        run = {k: after[k] - before[k] for k in after}
        idle = [k for k in must if run[k] == 0]
        if idle:
            raise AssertionError(f"GOP-parallel encode {label} with {workers} workers did "
                                 f"not launch {idle}")
        for k, v in run.items():
            enc[k] += v
        per_run[workers] = {k: v for k, v in run.items() if v}
    what = f"GOP-parallel encode {label} {mode} {src} {n} frames, segments of {seg}"
    if streams[0] != streams[1]:
        raise AssertionError(f"{what}: 2 workers and 1 give different streams "
                             f"({len(streams[0])} vs {len(streams[1])} bytes)")
    before = KN.launch_counts()
    dec = Decoder(device="cuda")
    pics = dec.decode_stream(streams[0])
    after = KN.launch_counts()
    if sorted(p.poc for p in pics) != list(range(n)) or len(dec.hash_results) != n \
            or not all(hr.ok for hr in dec.hash_results):
        raise AssertionError(f"{what}: the stream does not decode hash-exact to POCs 0-{n - 1}")
    dec_l = {k: after[k] - before[k] for k in after}
    left_out = [k for k in ENC_KERNELS if enc[k] == 0 and dec_l[k]]
    if left_out:
        raise AssertionError(f"{what}: the encodes did not launch {left_out}, which the "
                             "decode of the stream launches")
    print(f"{what} {cfgk} {enc_kw or {}}: {len(streams[0])} bytes, identical with 2 workers "
          f"and 1, decoded hash-exact on cuda; {secs[2] / n:.4f} s/picture with 2 workers, "
          f"{secs[1] / n:.4f} s/picture with 1 (ratio {secs[1] / secs[2]:.4f}x); host "
          f"os.cpu_count() {os.cpu_count()}, torch.get_num_threads() "
          f"{torch.get_num_threads()}, host CPU s / wall s {cores[2]:.4f} with 2 workers, "
          f"{cores[1]:.4f} with 1; launches with 2 workers (theirs, returned) "
          f"{per_run[2]}, with 1 (in-process) {per_run[1]}, decode of the stream "
          f"{ {k: v for k, v in dec_l.items() if v} }", flush=True)
    return enc, dec_l, size_key(w, h, "420")


def attribute(by_shape: dict, shape: str, launches: dict) -> None:
    """Add `launches` ({kernel: n}) to by_shape[shape]."""
    row = by_shape.setdefault(shape, {})
    for k, v in launches.items():
        row[k] = row.get(k, 0) + v


def attribute_encode(by_shape: dict, key: str, enc: dict, dec: dict) -> None:
    """An inter encode's launches (`enc`) and its stream's decode's (`dec`):
    the encode's MC at ENCODE, the rest at the pictures' size_key."""
    attribute(by_shape, ENCODE, {"vtm_mc_tiles": enc["vtm_mc_tiles"]})
    attribute(by_shape, key, {k: v for k, v in enc.items() if k != "vtm_mc_tiles"})
    attribute(by_shape, key, dec)


def check_attributed(by_shape: dict, total: dict, what: str) -> None:
    """Raise unless the launches attributed to shapes add up to the phase's
    counts: no launch of the phase is left without a shape."""
    summed = {k: sum(r.get(k, 0) for r in by_shape.values()) for k in total}
    if summed != total:
        raise AssertionError(f"{what}: launches by shape add up to {summed}, the phase "
                             f"launched {total}")


def redesign_order(chk: KernelCheck, launches: dict) -> list:
    """[(saving ms, kernel, parts)], largest first: per kernel, the sum over
    shapes of its launches there (launches: {kernel: {shape: n}}) x (device
    ms - bound ms) per launch of its timed cases at that shape."""
    order = []
    for name, by_shape in launches.items():
        gap, parts = 0.0, []
        for shape, n in by_shape.items():
            if n:
                per, bound = chk.per_launch(name, shape)
                gap += n * (per - bound)
                parts.append(f"{n} x ({per:.6f} - {bound:.6f}) ms at {shape}")
        order.append((gap, name, parts))
    return sorted(order, reverse=True)


def sao_ext_reach(chk: KernelCheck) -> None:
    """The extended-plane SAO's shard launches beside an empty kernel, a
    copy of a VER shard's plane and the vtm_halo_gather launch that builds
    every shard's extended plane ahead of them on the sharded chain (its
    1-column case, and the torch calls it replaced), timed in the same run:
    half of a launch's bound would need a launch within twice that bound."""
    cases = [c for c in chk.rows["vtm_sao_apply_ext"]["cases"]
             if c[0].startswith("1080p POC 0 shard")]
    ms = [m for _, m, _ in cases]
    bound = max(b for _, _, b in cases)

    def floor(prefix):
        return next(v for k, v in chk.floors.items() if k.startswith(prefix))

    gather = next(m for label, m, _ in chk.rows["vtm_halo_gather"]["cases"]
                  if "(SAO)" in label)
    print(f"vtm_sao_apply_ext at shard shape: {min(ms):.6f}-{max(ms):.6f} ms a launch, "
          f"bound at most {bound:.6f} ms, so half of it needs at most {2 * bound:.6f} ms; "
          f"an empty kernel takes {floor('torch.cuda._sleep'):.6f} ms, a torch copy_ of a "
          f"VER shard's plane (fewer bytes than a launch moves) "
          f"{floor('torch copy_ of VER'):.6f} ms; ahead of the {len(ms)} shard launches "
          f"of a picture the sharded chain spends {gather:.6f} ms of device time on one "
          f"vtm_halo_gather launch for all the lanes", flush=True)


def decode_golden(torch, KN, Decoder) -> dict:
    """Every golden stream of testdata/ decoded on the card: each picture
    hash-exact, and a stream whose pictures are not all hashed equal to the
    .dec.yuv (else .rec.yuv) beside it; prints each stream's launches.
    Returns, for each of LIVE_STREAMS, its pictures' planes and its seconds
    a picture (the mesh-off decode phase 6's live mesh is held to)."""
    import io

    import numpy as np

    from vtm_tpu_torch.utils import yuv_io

    names = sorted(f[:-4] for f in os.listdir(TESTDATA) if f.endswith(".bit"))
    kept = {}
    for name in names:
        before = KN.launch_counts()
        t0 = time.perf_counter()
        dec = Decoder(device="cuda")
        pics = dec.decode_stream(read_stream(name))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        after = KN.launch_counts()
        if not pics:
            raise AssertionError(f"golden {name}: no picture decoded")
        bad = [hr.poc for hr in dec.hash_results if not hr.ok]
        if bad:
            raise AssertionError(f"golden {name}: hash mismatch at POC {bad}")
        how = f"{len(dec.hash_results)} hashes OK"
        if len(dec.hash_results) < len(pics):
            sps = dec.psm.sps[pics[0].sps_id]
            h, w = pics[0].planes[0].shape
            fmt = yuv_io.YuvFormat(w, h, sps.chroma_format, sps.bit_depth)
            buf = io.BytesIO()
            for p in pics:
                yuv_io.write_frame(buf, p.planes, fmt)
            ref = next(os.path.join(TESTDATA, f"{name}{ext}")
                       for ext in (".dec.yuv", ".rec.yuv")
                       if os.path.exists(os.path.join(TESTDATA, f"{name}{ext}")))
            with open(ref, "rb") as f:
                if buf.getvalue() != f.read():
                    raise AssertionError(f"golden {name}: output != {os.path.basename(ref)}")
            how += f", output equal to {os.path.basename(ref)}"
        launched = {k: after[k] - before[k] for k in after if after[k] > before[k]}
        print(f"golden {name}: {len(pics)} pictures, {how}, {dt:.4f} s on cuda; "
              f"launches {launched}", flush=True)
        if name in LIVE_STREAMS:
            kept[name] = ([[np.asarray(p) for p in pic.planes] for pic in pics],
                          dt / len(pics))
    print(f"golden streams: all {len(names)} of testdata decoded exactly on the card",
          flush=True)
    missing = set(LIVE_STREAMS) - set(kept)
    if missing:
        raise AssertionError(f"the live mesh's streams {sorted(missing)} are not in testdata")
    return kept


def decode(torch, Decoder, name: str, chain_events: list) -> tuple[int, str]:
    """Decode one stream on the card, check every picture hash, and print
    seconds per picture and the chain's summed device time.  Returns the
    number of pictures and their size_key."""
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
    return len(pics), planes_key(pics[0].planes)


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
    from vtm_tpu_torch.ops import deblock_kernel as DK
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
    ptxas = ptxas_report(diag)
    for name, r in ptxas.items():
        print(f"  ptxas: {name}: {r}", flush=True)
    bad = [n for n, r in ptxas.items()
           if any(r.get(k) for k in NO_LOCAL_MEMORY.get(n.split("<")[0], ()))]
    if bad:
        raise AssertionError(f"kernels with spills or a stack frame: {bad}")
    for name, cfg in (DK.kernel_config() | halo_config(KN)).items():
        print(f"  launch shape {name}: {cfg}", flush=True)

    # 3. kernels against their plain versions
    chk = KernelCheck(torch)
    # the chain inputs of both pictures of the 1080p stream (decoded on the
    # card, hashes checked); POC 0's feed the kernel checks, both the
    # multi-device path of phase 6
    hd_cap = MCH.capture_decode(HD_STREAM, "cuda")
    pic0 = hd_cap["pics"][0]
    dev = torch.device("cuda")
    hd_key = time_chain_picture(torch, chk, pic0, dev, "1080p POC 0")
    check_filter_sizes(torch, chk, dev)
    random_case(torch, chk, dev)
    for stream in (RA_STREAM, INTER_SMALL_STREAM):
        got, key = capture_inter_inputs(MK, RK, Decoder, stream)
        check_inter_recorded(chk, got, MK, RK, stream, key)
    check_inter_1080p(chk, MK, RK, dev)
    check_encode_recorded(chk, capture_encode_mc(MK), MK)
    check_satd(chk, dev)
    check_rmd(torch, chk, T.hd_source()[0], 8, "1080p bq416 mirror-tiled", timed=True,
              ptxas=ptxas, shape=hd_key)
    for src, w, h in RMD_SIZE_SOURCES:
        check_rmd(torch, chk, T.read_source(src, w, h)[0], 8, f"{src} frame 0", timed=True,
                  ptxas=ptxas, shape=size_key(w, h, "420"))
    check_rmd(torch, chk, T.rmd_source(np.random.default_rng(13), 192, 256, 10),
              10, "10-bit 256x192 seeded", timed=False)
    check_rmd(torch, chk, T.rmd_source(np.random.default_rng(19), 1080, 1920, 10),
              10, "10-bit 1920x1080 seeded", timed=False)
    check_transforms(torch, chk, dev)
    check_shard_entries(torch, chk, pic0, dev)
    check_halo_kernels(torch, chk, pic0, dev)
    mesh_in = mesh_inputs(torch, dev)
    check_mesh_batches(torch, chk, mesh_in, dev)

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
            n_pics, key = decode(torch, Decoder, name, chain_events)
            after = KN.launch_counts()
            per_stream[name] = ({k: after[k] - before[k] for k in after}, n_pics, key)
    finally:
        FC.run_filter_chain = real_chain
    dec_counts = KN.launch_counts()
    # each stream's launches at its pictures' size
    dec_by = {}
    for launched, _, key in per_stream.values():
        attribute(dec_by, key, launched)
    check_attributed(dec_by, dec_counts, "the decode main path")
    hd, n_hd, _ = per_stream[HD_STREAM]
    print(f"launches, {HD_STREAM}: {hd}", flush=True)
    ra, _, _ = per_stream[RA_STREAM]
    print(f"launches, {RA_STREAM}: {ra}", flush=True)
    print(f"launches, decode main path: {dec_counts}", flush=True)
    if hd["vtm_deblock_luma_ver"] < 2 * n_hd:
        raise AssertionError("luma deblock ran fewer than twice per picture")
    if hd["vtm_sao_apply"] < 1 or hd["vtm_alf_filter"] < 1 \
            or hd["vtm_alf_classify"] < 1:
        raise AssertionError("SAO or ALF did not run on the 1080p stream")
    if any(ra[k] < 1 for k in INTER_KERNELS):
        raise AssertionError(f"an inter kernel did not run on {RA_STREAM}")
    mesh_off = decode_golden(torch, KN, Decoder)

    # 5. the encode main path, with the launch counts of this run only; the
    # CPU twin of the inter encode (a) runs beside it; the GOP-parallel
    # encodes after it, so that it takes no cores from their workers
    with cpu_twin(RA_ENC_SMALL) as twin:
        KN.reset_launch_counts()
        encodes = [encode_small(torch, KN, Decoder, IntraEncoder, name, kw)
                   for name, kw in ENC_CASES]
        hd_enc = encode_hd(torch, KN, Decoder, IntraEncoder)
        inter = {"(a)": encode_ra_small(torch, KN, Decoder, twin),
                 "(b)": encode_ra_d(torch, KN, Decoder)}
    gop = [encode_gop(torch, KN, Decoder, case) for case in GOP_CASES]
    enc_counts = KN.launch_counts()
    # each encode's launches and its stream's decode's at the pictures'
    # size, the inter encodes' own MC at ENCODE
    enc_by = {}
    for enc, dec in encodes:
        attribute(enc_by, size_key(208, 120, "420"), enc)
        attribute(enc_by, size_key(208, 120, "420"), dec)
    attribute(enc_by, size_key(1920, 1080, "420"), hd_enc[0])
    attribute(enc_by, size_key(1920, 1080, "420"), hd_enc[1])
    for case, (enc, dec) in zip((RA_ENC_SMALL, RA_ENC_D), inter.values()):
        attribute_encode(enc_by, size_key(case[1], case[2], "420"), enc, dec)
    for enc, dec, key in gop:
        attribute_encode(enc_by, key, enc, dec)
    check_attributed(enc_by, enc_counts, "the encode main path")
    alone = ([e for e, _ in encodes + [hd_enc] + list(inter.values())]
             + [e for e, _, _ in gop])
    enc_only = {k: sum(e[k] for e in alone) for k in enc_counts}
    print(f"launches, the encodes alone: {enc_only}", flush=True)
    print(f"launches, encode main path (the encodes and the decodes of their "
          f"streams): {enc_counts}", flush=True)
    idle = [k for k in ENC_KERNELS if enc_only[k] == 0]
    if idle:
        raise AssertionError(f"the encodes did not launch {idle}")
    # each inter encode runs its preselection through vtm_mc_tiles and its I
    # picture's RMD through the RMD kernels; a filter kernel one of them
    # leaves out must be one its stream does not use (the decode of the
    # stream launches it no more), and the two together launch every kernel
    # of INTER_ENC_KERNELS
    for label, (c, dec_l) in inter.items():
        idle = [k for k in ("vtm_mc_tiles", "vtm_rmd_angular", "vtm_rmd_reduce")
                if c[k] == 0]
        if idle:
            raise AssertionError(f"the inter encode {label} did not launch {idle}")
        for k in INTER_ENC_KERNELS:
            if c[k] == 0 and dec_l[k]:
                raise AssertionError(f"the inter encode {label} did not launch {k}, "
                                     "which the decode of its stream launches")
            if c[k] == 0:
                print(f"the inter encode {label} launched no {k}, nor does the decode "
                      "of its stream: its search left the tool off", flush=True)
    idle = [k for k in INTER_ENC_KERNELS if sum(c[k] for c, _ in inter.values()) == 0]
    if idle:
        raise AssertionError(f"the inter encodes did not launch {idle}")
    for k, why in NOT_IN_ENCODER.items():
        print(f"{k}: not launched by the encoder: {why}", flush=True)

    # 6. the multi-device main path, with the launch counts of this run only
    mesh_by = mesh_path(torch, KN, hd_cap, mesh_in)
    mesh_counts = {k: sum(c[k] for c in mesh_by.values()) for k in KN.KERNELS}
    print(f"launches, multi-device main path (one run of each stage): {mesh_counts}; "
          f"on shards {mesh_by['shard']}; on whole pictures (the gop-batched chain) "
          f"{ {s: c for s, c in mesh_by.items() if s != 'shard'} }", flush=True)
    idle = [k for k in MESH_KERNELS if mesh_counts[k] == 0]
    if idle:
        raise AssertionError(f"the multi-device path did not launch {idle}")
    # the live decode mesh, with its own counts
    live_by = live_mesh(torch, KN, chk, mesh_off)
    live_counts = {k: sum(c.get(k, 0) for c in live_by.values()) for k in KN.KERNELS}
    counts = {k: dec_counts[k] + enc_counts[k] + mesh_counts[k] + live_counts[k]
              for k in dec_counts}
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
              f"kernel {row['ms']:.6f} ms device, {row['call_ms']:.6f} ms call; "
              f"{row['launches']} launches in {row['timed']} timed calls", flush=True)
        for why in row["paced"]:
            print(f"  {name} {why}", flush=True)
        if row["library_ms"] is not None:
            print(f"library {name}: {row['library_ms']:.6f} ms device; the kernel is "
                  f"{'faster' if row['ms'] < row['library_ms'] else 'not faster'} "
                  f"({row['library_ms'] / row['ms']:.2f}x)", flush=True)
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces, launches=counts[name],
                            max_abs_err=row["max_abs_err"], ms=row["ms"],
                            call_ms=row["call_ms"], plain_ms=row["plain_ms"],
                            bound_ms=bound_ms, bound_by=bound_by,
                            library_ms=row["library_ms"]))
    # what a redesign of each kernel could save on the main paths at most,
    # each launch weighed at the shape it runs at: the size of its picture,
    # a lane's shard, or the inter encode's preselection call
    by_shape = {}
    for by in (dec_by, enc_by, mesh_by, live_by):
        for shape, launched in by.items():
            attribute(by_shape, shape, launched)
    for shape, launched in sorted(by_shape.items()):
        print(f"launches at {shape}: { {k: v for k, v in launched.items() if v} }",
              flush=True)
    launches = {k: {s: c.get(k, 0) for s, c in by_shape.items()} for k in KN.KERNELS}
    order = redesign_order(chk, launches)
    print("redesign order, main-path launches x (device ms - bound ms) per launch at the "
          "shape each runs at: " + ", ".join(f"{name} {gap:.6f} ms ({' + '.join(parts)})"
                                            for gap, name, parts in order), flush=True)
    sao_ext_reach(chk)
    torch.cuda.synchronize()
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--versus":
        import torch

        if not torch.cuda.is_available():
            print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
            sys.exit(1)
        sys.path.insert(0, ROOT)
        sys.exit(versus(torch, sys.argv[2]))
    sys.exit(main())
