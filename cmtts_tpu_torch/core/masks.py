"""Sequence masks and static-shape length bucketing (port of
``cmtts_tpu/core/masks.py``).

Bucket padding is part of the semantics, not only a compile detail: in the
default padded mode the inverse CWT standardises over the padded length
(``audio/pitch.py``), so the port pads to the same text and mel buckets as
the JAX pipeline.
"""

from __future__ import annotations

import bisect
from typing import Sequence

import numpy as np
import torch

DEFAULT_TEXT_BUCKETS: tuple[int, ...] = (32, 64, 96, 128, 192, 256)
DEFAULT_MEL_BUCKETS: tuple[int, ...] = (128, 256, 384, 512, 768, 1024, 1280)


def length_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """Boolean *padding* mask (B, max_len): True where position >= length."""
    ids = torch.arange(max_len, device=lengths.device)[None, :]
    return ids >= lengths[:, None].long()


def pick_bucket(length: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= length (clamps to the largest bucket)."""
    i = bisect.bisect_left(buckets, length)
    return buckets[min(i, len(buckets) - 1)]


def pad_to(x: np.ndarray, target: int, axis: int = 0, value=0) -> np.ndarray:
    """Host-side pad/truncate along ``axis`` to exactly ``target``."""
    n = x.shape[axis]
    if n == target:
        return x
    if n > target:
        sl = [slice(None)] * x.ndim
        sl[axis] = slice(0, target)
        return x[tuple(sl)]
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, target - n)
    return np.pad(x, widths, mode="constant", constant_values=value)
