"""The yardstick's arithmetic: the card's peaks, and the least work of the
in-loop filter chain counted as one operation.

Peaks of one H100 SXM at 700 W (NVIDIA's data sheet): 3.35 TB/s of HBM,
int32 lanes at 132 SMs x 64 x 1.98 GHz.

The chain's least work reads the pre-filter reconstruction, the filter
maps and the coefficients once each, and writes the filtered picture once,
all at the picture's own size and format (two bytes a sample above 8
bits).  It does not add up the stages' own bounds: what one stage writes
and the next reads is not counted, so the count is the same whether the
stages run fused or apart.  Operations are the stages' per-sample counts
(deblocking 10 a direction, SAO 8, the ALF classifier 12, the ALF filter 48
for luma and 24 for chroma, CC-ALF 14), for the stages that run.
"""

from __future__ import annotations

BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9

# deblocking: one byte a 4-sample edge segment on the 8-sample grid
EDGE_SAMPLES = 32
SAO_CTU_BYTES = 6  # type, band or class, 4 offsets
ALF_LUMA_COEF_BYTES = 25 * 12 * 2  # 25 classes x 12 coefficients and clips
ALF_CHROMA_COEF_BYTES = 8 * 6 * 2  # 8 alternatives x 6 coefficients and clips
CCALF_COEF_BYTES = 4 * 7  # 4 filters x 7 coefficients


def chain_work(shapes, bit_depth: int, flags, ctu: int) -> tuple[int, int]:
    """(bytes, int32 operations) of one picture's chain.

    shapes: the (h, w) of Y, Cb, Cr; flags: the chain's 15 stage flags
    (LMCS; deblocking VER luma, Cb, Cr; HOR luma, Cb, Cr; SAO Y, Cb, Cr;
    ALF Y, Cb, Cr; CC-ALF Cb, Cr); ctu: the CTU size in luma samples."""
    (lmcs, dvl, dvcb, dvcr, dhl, dhcb, dhcr, s0, s1, s2,
     a_l, a_cb, a_cr, a_cc1, a_cc2) = flags
    sizes = [h * w for h, w in shapes]
    y, c = sizes[0], sizes[1] + sizes[2]
    bps = 1 if bit_depth <= 8 else 2
    h, w = shapes[0]
    n_ctu = -(-h // ctu) * -(-w // ctu)
    nbytes = 2 * (y + c) * bps
    ops = 0
    if lmcs:
        nbytes += (1 << bit_depth) * bps
    for luma, cb, cr in ((dvl, dvcb, dvcr), (dhl, dhcb, dhcr)):
        if luma:
            ops += 10 * y
            nbytes += y // EDGE_SAMPLES
        if cb or cr:
            ops += 10 * c
            nbytes += c // EDGE_SAMPLES
    for on, n in zip((s0, s1, s2), sizes):
        if on:
            ops += 8 * n
            nbytes += SAO_CTU_BYTES * n_ctu
    if a_l:
        ops += (12 + 48) * y
        nbytes += n_ctu + ALF_LUMA_COEF_BYTES
    for on, n in ((a_cb, sizes[1]), (a_cr, sizes[2])):
        if on:
            ops += 24 * n
            nbytes += n_ctu + ALF_CHROMA_COEF_BYTES
    for on, n in ((a_cc1, sizes[1]), (a_cc2, sizes[2])):
        if on:
            ops += 14 * n
            nbytes += n_ctu + CCALF_COEF_BYTES
    return nbytes, ops


def least_s(nbytes: float, ops: float) -> float:
    """The least time the card could take for the work: the larger of its
    bytes over the memory's rate and its operations over the int32 peak."""
    return max(nbytes / BYTES_PER_S, ops / INT32_OPS_PER_S)


# the device functions of the inter prediction (MC, DMVR, the final FIR,
# BDOF), by the names the device trace gives them
INTER_KERNELS = frozenset({"mc_tiles_kernel", "dmvr_search_kernel", "fir_blocks_kernel",
                           "bdof_blend_kernel"})
