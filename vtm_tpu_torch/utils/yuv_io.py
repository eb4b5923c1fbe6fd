"""Planar YUV file I/O.

Covers the subset of the reference's `source/Lib/Utilities/VideoIOYuv.cpp`
(:127-1167) we need: 8/10/16-bit planar 4:0:0/4:2:0/4:2:2/4:4:4 read/write
with bit-depth shifts.  Frames are numpy int32 arrays (one per plane) —
conversion to device arrays happens at the codec boundary.
"""

from __future__ import annotations

import io
from dataclasses import dataclass

import numpy as np

from vtm_tpu_torch.common.types import ChromaFormat


@dataclass(frozen=True)
class YuvFormat:
    width: int
    height: int
    chroma: ChromaFormat
    bit_depth: int  # bits per sample in the FILE

    @property
    def bytes_per_sample(self) -> int:
        return 1 if self.bit_depth <= 8 else 2

    def plane_shape(self, comp: int) -> tuple[int, int]:
        if comp == 0 or self.chroma == ChromaFormat.YUV400:
            return (self.height, self.width)
        return (
            self.height >> self.chroma.scale_y,
            self.width >> self.chroma.scale_x,
        )

    @property
    def frame_bytes(self) -> int:
        n = 0
        for c in range(self.chroma.num_components):
            h, w = self.plane_shape(c)
            n += h * w * self.bytes_per_sample
        return n


def read_frame(f: io.BufferedIOBase, fmt: YuvFormat) -> list[np.ndarray] | None:
    """Read one frame; returns list of planes (int32) or None at EOF."""
    dtype = np.uint8 if fmt.bytes_per_sample == 1 else np.dtype("<u2")
    planes = []
    for c in range(fmt.chroma.num_components):
        h, w = fmt.plane_shape(c)
        raw = f.read(h * w * fmt.bytes_per_sample)
        if len(raw) < h * w * fmt.bytes_per_sample:
            return None
        planes.append(
            np.frombuffer(raw, dtype=dtype).reshape(h, w).astype(np.int32)
        )
    return planes


def write_frame(
    f: io.BufferedIOBase, planes: list[np.ndarray], fmt: YuvFormat
) -> None:
    dtype = np.uint8 if fmt.bytes_per_sample == 1 else np.dtype("<u2")
    for p in planes:
        f.write(np.ascontiguousarray(p, dtype=np.int64).astype(dtype).tobytes())


def read_yuv(path: str, fmt: YuvFormat, num_frames: int | None = None):
    """Read up to num_frames frames; returns list of frames."""
    frames = []
    with open(path, "rb") as f:
        while num_frames is None or len(frames) < num_frames:
            fr = read_frame(f, fmt)
            if fr is None:
                break
            frames.append(fr)
    return frames


def write_yuv(path: str, frames, fmt: YuvFormat) -> None:
    with open(path, "wb") as f:
        for fr in frames:
            write_frame(f, fr, fmt)


def scale_planes(planes: list[np.ndarray], shift: int) -> list[np.ndarray]:
    """Bit-depth shift as in VideoIOYuv scalePlane: <<s, or (x + off) >> s."""
    if shift == 0:
        return planes
    if shift > 0:
        return [p << shift for p in planes]
    s = -shift
    off = 1 << (s - 1)
    return [(p + off) >> s for p in planes]
