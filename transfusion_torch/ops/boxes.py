"""Box primitives with torchvision semantics over batched fixed-shape
tensors (port of ``transfusion_tpu/ops/boxes.py``). Boxes are
``[x1, y1, x2, y2]`` in pixels, shape ``[..., 4]``."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


def box_area(boxes):
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def box_iou(a, b):
    """Pairwise IoU. a: [..., N, 4], b: [..., M, 4] -> [..., N, M]."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(a)[..., :, None] + box_area(b)[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def clip_boxes(boxes, height, width):
    """Clamp boxes into [0, w] x [0, h] (torchvision clip_boxes_to_image)."""
    x = boxes[..., 0::2].clamp(0.0, float(width))
    y = boxes[..., 1::2].clamp(0.0, float(height))
    return torch.stack([x[..., 0], y[..., 0], x[..., 1], y[..., 1]], dim=-1)


def small_box_mask(boxes, min_size: float):
    """True where both sides are >= min_size (remove_small_boxes keep set)."""
    ws = boxes[..., 2] - boxes[..., 0]
    hs = boxes[..., 3] - boxes[..., 1]
    return (ws >= min_size) & (hs >= min_size)


# torchvision BoxCoder clamps dw/dh at log(1000/16) before exp.
BBOX_XFORM_CLIP = math.log(1000.0 / 16.0)


class BoxCoder(NamedTuple):
    """Delta -> box transform with torchvision weighting (RPN (1,1,1,1),
    RoI box head (10,10,5,5))."""

    weights: tuple = (1.0, 1.0, 1.0, 1.0)

    def encode(self, reference, proposals):
        """Regression targets of ``reference`` (gt) boxes with respect to
        ``proposals``; degenerate sides count as 1 (callers mask those rows)."""
        wx, wy, ww, wh = self.weights
        ex_w = proposals[..., 2] - proposals[..., 0]
        ex_h = proposals[..., 3] - proposals[..., 1]
        ex_cx = proposals[..., 0] + 0.5 * ex_w
        ex_cy = proposals[..., 1] + 0.5 * ex_h
        gt_w = reference[..., 2] - reference[..., 0]
        gt_h = reference[..., 3] - reference[..., 1]
        gt_cx = reference[..., 0] + 0.5 * gt_w
        gt_cy = reference[..., 1] + 0.5 * gt_h
        one = torch.ones_like(ex_w)
        safe_w = torch.where(ex_w > 0, ex_w, one)
        safe_h = torch.where(ex_h > 0, ex_h, one)
        safe_gt_w = torch.where(gt_w > 0, gt_w, one)
        safe_gt_h = torch.where(gt_h > 0, gt_h, one)
        dx = wx * (gt_cx - ex_cx) / safe_w
        dy = wy * (gt_cy - ex_cy) / safe_h
        dw = ww * torch.log(safe_gt_w / safe_w)
        dh = wh * torch.log(safe_gt_h / safe_h)
        return torch.stack([dx, dy, dw, dh], dim=-1)

    def decode(self, deltas, proposals):
        """Apply deltas [..., 4] (or [..., C, 4]) to proposals [..., 4]."""
        wx, wy, ww, wh = self.weights
        if deltas.dim() == proposals.dim() + 1:
            proposals = proposals[..., None, :]
        w = proposals[..., 2] - proposals[..., 0]
        h = proposals[..., 3] - proposals[..., 1]
        cx = proposals[..., 0] + 0.5 * w
        cy = proposals[..., 1] + 0.5 * h

        dx = deltas[..., 0] / wx
        dy = deltas[..., 1] / wy
        dw = torch.clamp(deltas[..., 2] / ww, max=BBOX_XFORM_CLIP)
        dh = torch.clamp(deltas[..., 3] / wh, max=BBOX_XFORM_CLIP)

        pred_cx = dx * w + cx
        pred_cy = dy * h + cy
        pred_w = torch.exp(dw) * w
        pred_h = torch.exp(dh) * h
        return torch.stack(
            [pred_cx - 0.5 * pred_w, pred_cy - 0.5 * pred_h,
             pred_cx + 0.5 * pred_w, pred_cy + 0.5 * pred_h],
            dim=-1,
        )
