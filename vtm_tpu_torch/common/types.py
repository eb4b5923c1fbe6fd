"""Core value types shared by every layer of the codec.

TPU-first re-design of the reference substrate (VTM `source/Lib/CommonLib/
Common.h`, `CommonDef.h`, `ChromaFormat.cpp`): instead of pointer-linked
buffer objects we keep plain dataclasses for geometry/metadata and numpy /
jax arrays for samples.  Samples are int32 on the exact path (VTM `Pel` is
int16 but all intermediate math is int32; int32 avoids silent overflow in
numpy) and int16/int32 in tensor kernels.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass


class ChromaFormat(enum.IntEnum):
    """Chroma sampling (ref: CommonDef.h ChromaFormat / ChromaFormat.cpp)."""

    YUV400 = 0
    YUV420 = 1
    YUV422 = 2
    YUV444 = 3

    @property
    def num_components(self) -> int:
        return 1 if self == ChromaFormat.YUV400 else 3

    @property
    def scale_x(self) -> int:
        """log2 horizontal subsampling of chroma relative to luma."""
        return 1 if self in (ChromaFormat.YUV420, ChromaFormat.YUV422) else 0

    @property
    def scale_y(self) -> int:
        """log2 vertical subsampling of chroma relative to luma."""
        return 1 if self == ChromaFormat.YUV420 else 0


class Component(enum.IntEnum):
    """Color component id (ref: CommonDef.h ComponentID)."""

    Y = 0
    CB = 1
    CR = 2

    @property
    def is_luma(self) -> bool:
        return self == Component.Y


class ChannelType(enum.IntEnum):
    LUMA = 0
    CHROMA = 1


def channel_type(comp: Component) -> ChannelType:
    return ChannelType.LUMA if comp == Component.Y else ChannelType.CHROMA


class SliceType(enum.IntEnum):
    """Ref: Slice.h SliceType — note VVC order B=0, P=1, I=2."""

    B = 0
    P = 1
    I = 2


@dataclass(frozen=True)
class Area:
    """A rectangle in component-local sample units."""

    x: int
    y: int
    w: int
    h: int

    @property
    def x1(self) -> int:
        return self.x + self.w

    @property
    def y1(self) -> int:
        return self.y + self.h

    def contains(self, px: int, py: int) -> bool:
        return self.x <= px < self.x1 and self.y <= py < self.y1


def comp_scale_x(comp: Component, fmt: ChromaFormat) -> int:
    return 0 if comp == Component.Y else fmt.scale_x


def comp_scale_y(comp: Component, fmt: ChromaFormat) -> int:
    return 0 if comp == Component.Y else fmt.scale_y


def clip3(lo: int, hi: int, v):
    """Normative Clip3 — works on ints and numpy arrays."""
    import numpy as np

    if isinstance(v, np.ndarray):
        return np.clip(v, lo, hi)
    return max(lo, min(hi, v))


def clip_bd(v, bit_depth: int):
    """Clip to [0, 2^bd - 1]."""
    return clip3(0, (1 << bit_depth) - 1, v)


# Fixed architectural limits, mirrored from the VVC spec / VTM CommonDef.h
MAX_CU_SIZE = 128
MAX_CU_DEPTH = 7  # CommonDef.h:310
MIN_CU_LOG2 = 2
MAX_NUM_REF_PICS = 16  # CommonDef.h:144
MAX_QP = 63
SCALING_LIST_REM_NUM = 6
MAX_TB_LOG2 = 6  # max transform block 64x64
