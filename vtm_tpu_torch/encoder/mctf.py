"""MCTF — motion-compensated temporal prefilter on source frames
(EncoderLib/EncTemporalFilter.cpp equivalent: filter:133,
motionEstimationLuma:360, bilateralFilter:226).

Shape follows the reference: filtered frames at an 8-frame cadence pull
up to ±2 neighbour frames through hierarchical 16x16 block motion
estimation, then blend per sample with error-adaptive bilateral weights
(strength 0.95 at poc%8, 1.5 at poc%16; sigma scales with QP). Integer-pel
ME here (the reference refines to sub-pel); the filter is non-normative.
"""

from __future__ import annotations

import math

import numpy as np


def _block_me(cur: np.ndarray, ref: np.ndarray, blk: int = 16, rng: int = 12):
    """Two-level integer block ME; returns (mvy, mvx) int arrays per block."""
    h, w = cur.shape
    nby, nbx = (h + blk - 1) // blk, (w + blk - 1) // blk
    # coarse level (/2)
    c2 = cur[::2, ::2].astype(np.int64)
    r2 = ref[::2, ::2].astype(np.int64)
    mvs = np.zeros((nby, nbx, 2), dtype=np.int32)
    h2, w2 = c2.shape
    b2 = blk // 2
    for by in range(nby):
        for bx in range(nbx):
            y0, x0 = by * b2, bx * b2
            y1, x1 = min(y0 + b2, h2), min(x0 + b2, w2)
            if y1 <= y0 or x1 <= x0:
                continue
            blk_c = c2[y0:y1, x0:x1]
            best = (1 << 62, 0, 0)
            step = rng // 2
            cy = cx = 0
            while step >= 1:
                improved = False
                for dy, dx in ((0, 0), (step, 0), (-step, 0), (0, step), (0, -step)):
                    my, mx = cy + dy, cx + dx
                    ys = np.clip(np.arange(y0 + my, y1 + my), 0, h2 - 1)
                    xs = np.clip(np.arange(x0 + mx, x1 + mx), 0, w2 - 1)
                    sad = int(np.abs(blk_c - r2[np.ix_(ys, xs)]).sum())
                    if sad < best[0]:
                        best = (sad, my, mx)
                        improved = True
                cy, cx = best[1], best[2]
                if not improved:
                    step >>= 1
            mvs[by, bx] = (2 * best[1], 2 * best[2])
    # full-res refinement ±2
    cur64 = cur.astype(np.int64)
    ref64 = ref.astype(np.int64)
    for by in range(nby):
        for bx in range(nbx):
            y0, x0 = by * blk, bx * blk
            y1, x1 = min(y0 + blk, h), min(x0 + blk, w)
            blk_c = cur64[y0:y1, x0:x1]
            base_y, base_x = int(mvs[by, bx, 0]), int(mvs[by, bx, 1])
            best = (1 << 62, base_y, base_x)
            for dy in (-2, -1, 0, 1, 2):
                for dx in (-2, -1, 0, 1, 2):
                    my, mx = base_y + dy, base_x + dx
                    ys = np.clip(np.arange(y0 + my, y1 + my), 0, h - 1)
                    xs = np.clip(np.arange(x0 + mx, x1 + mx), 0, w - 1)
                    sad = int(np.abs(blk_c - ref64[np.ix_(ys, xs)]).sum())
                    if sad < best[0]:
                        best = (sad, my, mx)
            mvs[by, bx] = (best[1], best[2])
    return mvs


def _compensate(ref: np.ndarray, mvs: np.ndarray, blk: int) -> np.ndarray:
    h, w = ref.shape
    out = np.empty_like(ref)
    nby, nbx = mvs.shape[:2]
    for by in range(nby):
        for bx in range(nbx):
            y0, x0 = by * blk, bx * blk
            y1, x1 = min(y0 + blk, h), min(x0 + blk, w)
            if y1 <= y0 or x1 <= x0:
                continue
            my, mx = int(mvs[by, bx, 0]), int(mvs[by, bx, 1])
            ys = np.clip(np.arange(y0 + my, y1 + my), 0, h - 1)
            xs = np.clip(np.arange(x0 + mx, x1 + mx), 0, w - 1)
            out[y0:y1, x0:x1] = ref[np.ix_(ys, xs)]
    return out


def mctf_filter(frames, qp: int, bit_depth: int = 8,
                cadence: int = 8) -> list:
    """Filter the source frames in place-style: returns a new list where
    frames at poc % cadence == 0 are temporally filtered."""
    n = len(frames)
    out = []
    maxv = (1 << bit_depth) - 1
    for poc in range(n):
        if poc % cadence or n == 1:
            out.append(frames[poc])
            continue
        strength = 1.5 if poc % (2 * cadence) == 0 else 0.95
        neighbours = [p for p in (poc - 2, poc - 1, poc + 1, poc + 2)
                      if 0 <= p < n]
        if not neighbours:
            out.append(frames[poc])
            continue
        cur = frames[poc]
        # per-neighbour luma ME, reused scaled for chroma
        comps_acc = [np.zeros(c.shape, dtype=np.float64) for c in cur]
        wsum = [np.zeros(c.shape, dtype=np.float64) for c in cur]
        # sigma from QP (EncTemporalFilter sigma model)
        sigma = 30.0 * ((qp - 20) / 40.0) if qp > 20 else 1.5
        sigma = max(1.5, sigma) * (maxv / 255.0)
        for p in neighbours:
            dist = abs(p - poc)
            s_frame = strength / dist
            mvs = _block_me(cur[0], frames[p][0])
            for c in range(len(cur)):
                scale = 1 if c == 0 else 2
                if c == 0:
                    mv_c = mvs
                    blk = 16
                else:
                    mv_c = mvs // scale
                    blk = 16 // scale
                pred = _compensate(frames[p][c], mv_c, blk)
                diff = pred.astype(np.float64) - cur[c]
                wgt = s_frame * np.exp(-(diff * diff) / (2.0 * sigma * sigma))
                comps_acc[c] += wgt * pred
                wsum[c] += wgt
        filtered = []
        for c in range(len(cur)):
            v = (cur[c] + comps_acc[c]) / (1.0 + wsum[c])
            filtered.append(np.clip(np.round(v), 0, maxv).astype(cur[c].dtype))
        out.append(filtered)
    return out
