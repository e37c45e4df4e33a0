"""Visualization callbacks (port of ``transfusion_tpu/runner/callbacks.py``):
GT vs predicted bounding-box grids and the legacy heatmap grids.

Matplotlib equivalent of ``runner/utils/callbacks.py:237-409``
(BboxPlotterCallback): a grid of sample frames with ground-truth boxes in
green and the top-k predictions in red, annotated with noun/verb names, TTC
and score, written under ``{run_dir}/plots/{split}/epoch_{n}.jpg`` once
per epoch after validation. Matplotlib is imported inside the functions
that draw, so the trainer runs without it.
"""

from __future__ import annotations

import os

import numpy as np


def denormalize_image(img: np.ndarray, normalization: str) -> np.ndarray:
    """Undo data.transforms.normalize back to uint8 RGB-ish for display.
    Channel order is whatever the pipeline produced (BGR for the shipped
    configs) — flipped back for display."""
    from transfusion_torch.data.transforms import NORM_TABLE

    mean, std = NORM_TABLE[normalization]
    x = img * std + mean
    return np.clip(x * 255.0, 0, 255).astype(np.uint8)


def plot_boxes_grid(
    images: np.ndarray,
    gt_boxes: list[np.ndarray],
    pred_boxes: list[np.ndarray],
    pred_labels: list[list[str]] | None = None,
    gt_labels: list[str] | None = None,
    out_path: str | None = None,
    cols: int = 4,
    normalization: str = "ego4d_baseline",
    channel_order: str = "BGR",
):
    """images [N, H, W, 3] (normalized); boxes in image coordinates."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = len(images)
    rows = -(-n // cols)
    fig, axes = plt.subplots(rows, cols, figsize=(4 * cols, 3 * rows))
    axes = np.atleast_1d(axes).reshape(-1)
    for i in range(len(axes)):
        ax = axes[i]
        ax.axis("off")
        if i >= n:
            continue
        img = denormalize_image(images[i], normalization)
        if channel_order == "BGR":
            img = img[..., ::-1]
        ax.imshow(img)
        for b in np.asarray(gt_boxes[i]).reshape(-1, 4):
            ax.add_patch(
                plt.Rectangle((b[0], b[1]), b[2] - b[0], b[3] - b[1],
                              fill=False, edgecolor="lime", linewidth=2)
            )
        if gt_labels:
            ax.set_title(gt_labels[i], fontsize=8)
        preds = np.asarray(pred_boxes[i]).reshape(-1, 4)
        for j, b in enumerate(preds):
            ax.add_patch(
                plt.Rectangle((b[0], b[1]), b[2] - b[0], b[3] - b[1],
                              fill=False, edgecolor="red", linewidth=1)
            )
            if pred_labels and j < len(pred_labels[i]):
                ax.text(b[0], max(b[1] - 2, 0), pred_labels[i][j], color="red", fontsize=6)
    fig.tight_layout()
    if out_path:
        os.makedirs(os.path.dirname(out_path), exist_ok=True)
        fig.savefig(out_path, dpi=110)
        plt.close(fig)
        return out_path
    return fig


class BboxPlotter:
    """Per-epoch plotting hook fed with a fixed sample batch + detections."""

    def __init__(self, run_dir: str, noun_names: dict[int, str], verb_names: dict[int, str],
                 normalization: str = "ego4d_baseline", channel_order: str = "BGR", top_k: int = 5):
        self.plot_dir = os.path.join(run_dir, "plots")
        self.noun_names = noun_names
        self.verb_names = verb_names
        self.normalization = normalization
        self.channel_order = channel_order
        self.top_k = top_k

    def __call__(self, split: str, epoch: int, batch: dict, dets: dict) -> str:
        images = np.asarray(batch["image"])
        t = batch["targets"]
        gt_boxes, gt_labels, pred_boxes, pred_labels = [], [], [], []
        for i in range(len(images)):
            gv = np.asarray(t["valid"][i])
            gt_boxes.append(np.asarray(t["boxes"][i])[gv])
            nouns = np.asarray(t["nouns"][i])[gv]
            verbs = np.asarray(t["verbs"][i])[gv]
            gt_labels.append(
                ", ".join(
                    f"{self.noun_names.get(int(n), n)}/{self.verb_names.get(int(v), v)}"
                    for n, v in zip(nouns, verbs)
                )
            )
            v = np.asarray(dets["valid"][i])
            order = np.argsort(-np.asarray(dets["scores"][i]))[: self.top_k]
            keep = [j for j in order if v[j]]
            pred_boxes.append(np.asarray(dets["boxes"][i])[keep])
            pred_labels.append(
                [
                    f"{self.noun_names.get(int(dets['nouns'][i][j]), dets['nouns'][i][j])}"
                    f"/{self.verb_names.get(int(dets['verbs'][i][j]), dets['verbs'][i][j])}"
                    f" {float(dets['ttcs'][i][j]):.2f}s {float(dets['scores'][i][j]):.2f}"
                    for j in keep
                ]
            )
        out = os.path.join(self.plot_dir, split, f"epoch_{epoch:03d}.jpg")
        return plot_boxes_grid(
            images, gt_boxes, pred_boxes, pred_labels, gt_labels, out,
            normalization=self.normalization, channel_order=self.channel_order,
        )


def plot_heatmap_grid(
    images: np.ndarray,
    gt_heatmaps: np.ndarray,
    pred_heatmaps: np.ndarray,
    titles: list[str] | None = None,
    out_path: str | None = None,
    normalization: str = "ego4d_baseline",
    channel_order: str = "BGR",
):
    """Legacy snao heatmap grids (HmapPlotterCallback,
    runner/utils/callbacks.py:76-234): per sample a row of
    [frame | GT heatmap overlay | predicted heatmap overlay]."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = len(images)
    fig, axes = plt.subplots(n, 3, figsize=(12, 3 * n), squeeze=False)
    for i in range(n):
        img = denormalize_image(images[i], normalization)
        if channel_order == "BGR":
            img = img[..., ::-1]
        for j, (ax, hmap, label) in enumerate(zip(
            axes[i], (None, gt_heatmaps[i], pred_heatmaps[i]), ("frame", "gt", "pred")
        )):
            ax.axis("off")
            ax.imshow(img)
            if hmap is not None:
                h = np.asarray(hmap, np.float32)
                h = h / max(float(h.max()), 1e-6)
                ax.imshow(h, alpha=0.55, cmap="jet",
                          extent=(0, img.shape[1], img.shape[0], 0))
            t = label if titles is None or j != 0 else f"{titles[i]}"
            ax.set_title(t, fontsize=8)
    fig.tight_layout()
    if out_path:
        os.makedirs(os.path.dirname(out_path), exist_ok=True)
        fig.savefig(out_path, dpi=80)
    plt.close(fig)
    return out_path


class HmapPlotter:
    """HmapPlotterCallback equivalent for the legacy heatmap family."""

    def __init__(self, run_dir: str, normalization: str = "ego4d_baseline",
                 channel_order: str = "BGR"):
        self.plot_dir = os.path.join(run_dir, "plots")
        self.normalization = normalization
        self.channel_order = channel_order

    def __call__(self, split: str, epoch: int, images, gt_heatmaps, pred_heatmaps,
                 titles=None) -> str:
        out = os.path.join(self.plot_dir, split, f"hmap_epoch_{epoch}.jpg")
        return plot_heatmap_grid(
            np.asarray(images), np.asarray(gt_heatmaps), np.asarray(pred_heatmaps),
            titles=titles, out_path=out, normalization=self.normalization,
            channel_order=self.channel_order,
        )
