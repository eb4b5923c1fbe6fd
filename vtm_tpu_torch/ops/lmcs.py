"""LMCS (luma mapping with chroma scaling) — exact integer reference.

Behavioral contract from CommonLib/Reshape.cpp: PWL model construction
(constructReshaper:240), forward/inverse LUTs, chroma residual scale
derivation (calculateChromaAdjVpduNei:106) and the residual scaling
(Buffer.cpp AreaBuf<Pel>::scaleSignal:416).
"""

from __future__ import annotations

import numpy as np

PIC_CODE_CW_BINS = 16
FP_PREC = 11
CSCALE_FP_PREC = 11


class LmcsModel:
    def __init__(self, aps, bit_depth: int):
        self.bit_depth = bit_depth
        lut_size = 1 << bit_depth
        init_cw = lut_size // PIC_CODE_CW_BINS
        self.init_cw = init_cw
        self.min_bin = aps.lmcs_min_bin_idx
        self.max_bin = PIC_CODE_CW_BINS - 1 - aps.lmcs_delta_max_bin_idx
        bin_cw = np.zeros(PIC_CODE_CW_BINS, dtype=np.int64)
        for i in range(self.min_bin, self.max_bin + 1):
            bin_cw[i] = aps.lmcs_cw[i] + init_cw
        self.bin_cw = bin_cw
        crs_offset = aps.lmcs_delta_crs
        pwl_bin_len = lut_size // PIC_CODE_CW_BINS
        log2_bin = pwl_bin_len.bit_length() - 1
        self.reshape_pivot = np.zeros(PIC_CODE_CW_BINS + 1, dtype=np.int64)
        self.input_pivot = np.zeros(PIC_CODE_CW_BINS + 1, dtype=np.int64)
        self.fwd_scale = np.zeros(PIC_CODE_CW_BINS, dtype=np.int64)
        self.inv_scale = np.zeros(PIC_CODE_CW_BINS, dtype=np.int64)
        self.chroma_adj_lut = np.zeros(PIC_CODE_CW_BINS, dtype=np.int64)
        for i in range(PIC_CODE_CW_BINS):
            self.reshape_pivot[i + 1] = self.reshape_pivot[i] + bin_cw[i]
            self.input_pivot[i + 1] = self.input_pivot[i] + init_cw
            self.fwd_scale[i] = (bin_cw[i] * (1 << FP_PREC) + (1 << (log2_bin - 1))) >> log2_bin
            if bin_cw[i] == 0:
                self.inv_scale[i] = 0
                self.chroma_adj_lut[i] = 1 << CSCALE_FP_PREC
            else:
                self.inv_scale[i] = init_cw * (1 << FP_PREC) // int(bin_cw[i])
                self.chroma_adj_lut[i] = init_cw * (1 << FP_PREC) // (int(bin_cw[i]) + crs_offset)
        maxv = lut_size - 1
        samples = np.arange(lut_size, dtype=np.int64)
        idx = samples // init_cw
        self.fwd_lut = np.clip(
            self.reshape_pivot[idx]
            + ((self.fwd_scale[idx] * (samples - self.input_pivot[idx]) + (1 << (FP_PREC - 1))) >> FP_PREC),
            0, maxv,
        ).astype(np.int32)
        idx_inv = np.array([self.pwl_idx_inv(int(s)) for s in samples])
        self.inv_lut = np.clip(
            self.input_pivot[idx_inv]
            + ((self.inv_scale[idx_inv] * (samples - self.reshape_pivot[idx_inv]) + (1 << (FP_PREC - 1))) >> FP_PREC),
            0, maxv,
        ).astype(np.int32)

    def pwl_idx_inv(self, luma_val: int) -> int:
        idx = self.min_bin
        while idx <= self.max_bin:
            if luma_val < self.reshape_pivot[idx + 1]:
                break
            idx += 1
        return min(idx, PIC_CODE_CW_BINS - 1)

    def chroma_adj(self, avg_luma: int) -> int:
        return int(self.chroma_adj_lut[self.pwl_idx_inv(avg_luma)])


def scale_signal_inverse(resi: np.ndarray, scale: int, bit_depth: int) -> np.ndarray:
    """scaleSignal(dir=False): chroma residual inverse scaling."""
    max_abs = (1 << bit_depth) - 1
    r = np.clip(resi.astype(np.int64), -max_abs - 1, max_abs)
    sign = np.where(r >= 0, 1, -1)
    absval = sign * r
    val = sign * ((absval * scale + (1 << (CSCALE_FP_PREC - 1))) >> CSCALE_FP_PREC)
    return np.clip(val, -32768, 32767).astype(np.int32)
