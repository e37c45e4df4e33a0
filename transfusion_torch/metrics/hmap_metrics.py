"""Legacy heatmap metrics (``runner/metrics_losses/hmap_metrics.py``; a
numpy copy of ``transfusion_tpu/metrics/hmap_metrics.py``).

The snao/heatmap experiment family scores predicted attention heatmaps with
three streaming metrics: a per-target-max-normalized MAE, a heatmap
"accuracy" (summed |diff| over the count of above-1-std target pixels), and a
Chebyshev argmax-coordinate distance normalized by the image size. Host-side
numpy streaming classes, matching torchmetrics accumulate-then-compute
semantics.
"""

from __future__ import annotations

import numpy as np


class MAEWithNorm:
    """MAEwithNorm (hmap_metrics.py:8-20): optional division of both maps by
    the per-sample target max before a standard streaming MAE."""

    def __init__(self, metric_norm: bool = True):
        self.metric_norm = metric_norm
        self.abs_sum = 0.0
        self.count = 0

    def update(self, preds: np.ndarray, target: np.ndarray):
        preds = np.asarray(preds, np.float64)
        target = np.asarray(target, np.float64)
        if self.metric_norm:
            tmax = target.max(axis=(-1, -2), keepdims=True)
            target = target / tmax
            preds = preds / tmax
        self.abs_sum += float(np.abs(preds - target).sum())
        self.count += preds.size

    def compute(self) -> float:
        return self.abs_sum / max(self.count, 1)


class HeatmapAccuracy:
    """HeatmapAccuracy (hmap_metrics.py:23-69): cumulative |diff| divided by
    the number of target pixels above the per-sample (unbiased) std."""

    def __init__(self, metric_norm: bool = True):
        self.metric_norm = metric_norm
        self.diffs_cum_sum = 0.0
        self.total = 0.0

    def update(self, preds: np.ndarray, target: np.ndarray):
        preds = np.asarray(preds, np.float64)
        target = np.asarray(target, np.float64)
        assert preds.shape == target.shape
        if self.metric_norm:
            tmax = target.max(axis=(-1, -2), keepdims=True)
            target = target / tmax
            preds = preds / tmax
        std = target.std(axis=(-1, -2), keepdims=True, ddof=1)
        self.total += float((target > std).sum())
        self.diffs_cum_sum += float(np.abs(preds - target).sum())

    def compute(self) -> float:
        return self.diffs_cum_sum / self.total


class CoordMetric:
    """CoordMetric (hmap_metrics.py:99-123): mean over samples of the
    per-axis-normalized Chebyshev distance between pred/target argmaxes."""

    def __init__(self, img_h_w):
        self.img_h_w = np.asarray(img_h_w, np.float64)
        self.diffs_cum_sum = 0.0
        self.total = 0

    def update(self, preds: np.ndarray, target: np.ndarray):
        preds = np.asarray(preds, np.float64)
        target = np.asarray(target, np.float64)
        assert preds.shape == target.shape
        n = preds.shape[0]
        shape = preds.shape[1:]
        t_idx = np.stack(np.unravel_index(target.reshape(n, -1).argmax(-1), shape), -1)
        p_idx = np.stack(np.unravel_index(preds.reshape(n, -1).argmax(-1), shape), -1)
        dists = (np.abs(t_idx - p_idx) / self.img_h_w).max(-1)
        self.diffs_cum_sum += float(dists.sum())
        self.total += n

    def compute(self) -> float:
        return self.diffs_cum_sum / max(self.total, 1)
