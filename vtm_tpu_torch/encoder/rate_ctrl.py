"""λ-domain rate control (EncoderLib/RateCtrl.cpp equivalent).

R-λ model (JCTVC-K0103, the reference's EncRCSeq/EncRCPic hierarchy,
RateCtrl.h:99-246): per-picture target bits from the sequence budget with
a smoothing window, λ = α·bpp^β, QP = 4.2005·ln λ + 13.7122, and α/β
LMS updates from the actual bits after each picture
(EncRCPic::updateAfterPicture, RateCtrl.cpp).
"""

from __future__ import annotations

import math


ALPHA_INTRA, BETA_INTRA = 6.7542, 1.7860  # intra model (RateCtrl.cpp:58)
ALPHA_MIN, ALPHA_MAX = 0.05, 500.0
BETA_MIN, BETA_MAX = -3.0, -0.1
LAMBDA_EPS = 0.1


class CtuRateControl:
    """CTU-level R-λ allocation (behavioral counterpart of
    EncRCPic::getLCUTargetBpp / updateAfterCTU, RateCtrl.h:189-247):
    the remaining picture budget is split over the remaining CTUs by
    complexity weight, each CTU gets λ = α·bpp^β clipped around the
    picture λ, QP clipped to pic_qp ± 2, and α/β are LMS-updated from
    the observed CTU bits (coded via cu_qp_delta)."""

    def __init__(self, pic_target_bits: float, weights, pic_lambda: float,
                 pic_qp: int, pixels_per_ctu):
        self.remaining = float(pic_target_bits)
        self.weights = [max(w, 1e-3) for w in weights]
        self.wsum = sum(self.weights) or 1.0
        self.ppc = list(pixels_per_ctu)
        self.pic_lambda = pic_lambda
        self.pic_qp = pic_qp
        self.alpha, self.beta = 3.2003, -1.367
        self.i = 0
        self._lam = pic_lambda

    def ctu_qp(self):
        """(qp, lambda) for the next CTU in raster order."""
        i = self.i
        t = max(10.0, self.remaining * self.weights[i] / self.wsum)
        bpp = t / self.ppc[i]
        lam = self.alpha * (bpp ** self.beta)
        lam = max(self.pic_lambda * 0.25, min(self.pic_lambda * 4.0, lam))
        qp = int(round(4.2005 * math.log(max(lam, LAMBDA_EPS)) + 13.7122))
        qp = max(self.pic_qp - 2, min(self.pic_qp + 2, qp))
        self._lam = lam
        return qp, lam

    def update(self, actual_bits: float) -> None:
        """Model + budget update after the CTU's bits are known."""
        i = self.i
        self.wsum -= self.weights[i]
        self.remaining -= actual_bits
        bpp = max(actual_bits / self.ppc[i], 1e-6)
        lam_comp = max(LAMBDA_EPS, self.alpha * (bpp ** self.beta))
        delta = math.log(self._lam) - math.log(lam_comp)
        self.alpha += 0.10 * delta * self.alpha
        self.beta += 0.05 * delta * math.log(bpp)
        self.alpha = max(ALPHA_MIN, min(ALPHA_MAX, self.alpha))
        self.beta = max(BETA_MIN, min(BETA_MAX, self.beta))
        self.i += 1


class RateControl:
    """Picture-level rate control; slice-QP granularity."""

    def __init__(self, target_bps: float, fps: float, width: int, height: int,
                 smooth_window: int = 16, base_qp: int = 32):
        self.pixels = width * height
        self.bits_per_pic = target_bps / fps
        self.window = smooth_window
        self.buffer = 0.0  # bits owed (positive = under budget so far)
        # inter R-λ model (RateCtrl.cpp:53 g_RCAlpha/g_RCBeta defaults)
        self.alpha = 3.2003
        self.beta = -1.367
        self.base_qp = base_qp
        self.last_lambda = None

    # -- per-picture ----------------------------------------------------
    def picture_target(self) -> float:
        """Target bits for the next picture with budget smoothing
        (EncRCPic::xEstPicTargetBits)."""
        t = self.bits_per_pic + self.buffer / self.window
        return max(100.0, t)

    def picture_lambda_qp(self, is_intra: bool = False):
        """(lambda, qp) for the next picture (estimatePicLambda,
        RateCtrl.cpp:239)."""
        target = self.picture_target()
        bpp = target / self.pixels
        if is_intra:
            # intra pictures spend more bits; scale target up
            bpp *= 4.0
        lam = self.alpha * (bpp ** self.beta)
        lam = max(LAMBDA_EPS, min(10000.0, lam))
        if self.last_lambda is not None:
            # clip λ swing 2^±1 per picture (RateCtrl.cpp lambda clip)
            lam = max(self.last_lambda * 0.5, min(self.last_lambda * 2.0, lam))
        qp = int(round(4.2005 * math.log(lam) + 13.7122))
        qp = max(1, min(51, qp))
        return lam, qp

    def update_after_picture(self, actual_bits: int, lam_used: float,
                             is_intra: bool = False) -> None:
        """α/β LMS update + budget bookkeeping
        (EncRCPic::updateAfterPicture / xUpdateSequenceModel)."""
        self.buffer += self.bits_per_pic - actual_bits
        self.last_lambda = lam_used
        if is_intra:
            return  # keep the inter model clean; intra uses scaled target
        bpp = max(actual_bits / self.pixels, 1e-6)
        lambda_comp = self.alpha * (bpp ** self.beta)
        lambda_comp = max(LAMBDA_EPS, lambda_comp)
        delta = math.log(lam_used) - math.log(lambda_comp)
        self.alpha += 0.10 * delta * self.alpha
        self.beta += 0.05 * delta * math.log(bpp)
        self.alpha = max(ALPHA_MIN, min(ALPHA_MAX, self.alpha))
        self.beta = max(BETA_MIN, min(BETA_MAX, self.beta))
