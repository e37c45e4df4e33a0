"""Heatmap target math for the legacy snao experiments (a numpy copy of
``transfusion_tpu/data/heatmaps.py``, which the port may not import).

Functional port of ``data_preprocessing/utils/math_utils.py`` (constant /
gaussian / distribution-normalized box heatmaps over a mapped coordinate
space). The egonao path never consumes these; the heatmap family
(``models/resnet_nao.py``, ``scnn.py``, ``heatmap_fusion.py``) trains on
them.
"""

from __future__ import annotations

import numpy as np

MAX_STD = 5.0


def get_lin_space(width: int, height: int, max_std_w: float = MAX_STD, max_std_h: float = MAX_STD):
    """Map pixel coordinates onto [-max_std, max_std] axes."""
    return np.linspace(-max_std_w, max_std_w, width), np.linspace(-max_std_h, max_std_h, height)


def gaus2d(x, y, mx=0.0, my=0.0, sx=1.0, sy=1.0):
    return (
        1.0
        / (2.0 * np.pi * sx * sy)
        * np.exp(-((x - mx) ** 2.0 / (2.0 * sx**2.0) + (y - my) ** 2.0 / (2.0 * sy**2.0)))
    )


def boxes_area(boxes: np.ndarray) -> float:
    b = np.asarray(boxes, np.float64).reshape(-1, 4)
    return float(((b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])).sum())


def const_heatmap(boxes: np.ndarray, height: int, width: int) -> np.ndarray:
    """1.0 inside any box, 0 elsewhere."""
    hm = np.zeros((height, width), np.float32)
    for b in np.asarray(boxes).reshape(-1, 4):
        x1, y1, x2, y2 = (int(round(v)) for v in b)
        hm[max(y1, 0) : max(y2, 0), max(x1, 0) : max(x2, 0)] = 1.0
    return hm


def gaussian_heatmap(
    boxes: np.ndarray, height: int, width: int, normalize: bool = False
) -> np.ndarray:
    """Per-box 2d gaussians centered on box centers, std tied to box size in
    the mapped coordinate space; optionally normalized to a distribution."""
    xs, ys = get_lin_space(width, height, MAX_STD, MAX_STD * height / width)
    gx, gy = np.meshgrid(xs, ys)
    hm = np.zeros((height, width), np.float64)
    for b in np.asarray(boxes).reshape(-1, 4):
        cx = (b[0] + b[2]) / 2.0 / width
        cy = (b[1] + b[3]) / 2.0 / height
        bw = max((b[2] - b[0]) / width, 1e-3)
        bh = max((b[3] - b[1]) / height, 1e-3)
        mx = (cx * 2 - 1) * MAX_STD
        my = (cy * 2 - 1) * MAX_STD * height / width
        hm += gaus2d(gx, gy, mx, my, bw * MAX_STD, bh * MAX_STD * height / width)
    if normalize and hm.sum() > 0:
        hm = hm / hm.sum()
    elif hm.max() > 0:
        hm = hm / hm.max()
    return hm.astype(np.float32)


def get_img_heatmap(kind: str):
    if kind == "const":
        return const_heatmap
    if kind == "gaussian":
        return lambda b, h, w: gaussian_heatmap(b, h, w, normalize=False)
    if kind == "gaussian_dist":
        return lambda b, h, w: gaussian_heatmap(b, h, w, normalize=True)
    raise ValueError(f"unknown heatmap type {kind}")
