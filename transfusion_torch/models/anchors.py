"""Anchor generation with torchvision semantics (port of
``transfusion_tpu/models/anchors.py``). Anchors depend only on static
shapes, so they are computed with numpy and cached per shape."""

from __future__ import annotations

import functools
import math
from typing import Sequence

import numpy as np


def cell_anchors(size: float, aspect_ratios: Sequence[float]) -> np.ndarray:
    """Zero-centred base anchors, rounded like torchvision."""
    out = []
    for a in aspect_ratios:
        h = size * math.sqrt(a)
        w = size / math.sqrt(a)
        out.append([-w / 2.0, -h / 2.0, w / 2.0, h / 2.0])
    return np.round(np.asarray(out, dtype=np.float32))


@functools.lru_cache(maxsize=16)
def grid_anchors(
    feature_shapes: tuple,
    image_size: tuple,
    sizes: tuple = (32, 64, 128, 256, 512),
    aspect_ratios: tuple = (0.5, 1.0, 2.0),
) -> tuple:
    """Per-level anchor arrays [H*W*A, 4] in image coordinates, (H, W, A)
    order. Strides are image_size // feature_size, as torchvision computes
    them at call time. Arguments are tuples (the result is cached)."""
    assert len(feature_shapes) == len(sizes), "one size group per level"
    ih, iw = image_size
    out = []
    for (fh, fw), size in zip(feature_shapes, sizes):
        stride_h, stride_w = ih // fh, iw // fw
        base = cell_anchors(size, aspect_ratios)
        shift_x = np.arange(fw, dtype=np.float32) * stride_w
        shift_y = np.arange(fh, dtype=np.float32) * stride_h
        sx, sy = np.meshgrid(shift_x, shift_y)
        shifts = np.stack([sx, sy, sx, sy], axis=-1).reshape(-1, 1, 4)
        out.append((shifts + base[None]).reshape(-1, 4).astype(np.float32))
    return tuple(out)
