"""Region proposal network, static-shape eval path (port of
``transfusion_tpu/models/rpn.py``): torchvision head, per-level top-k,
decode, clip, small-box and score masks, per-level NMS and a fixed
``post_nms_top_n`` slots with a validity mask."""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from transfusion_torch.models.anchors import grid_anchors
from transfusion_torch.models.resnet import conv
from transfusion_torch.ops.boxes import BoxCoder, clip_boxes, small_box_mask
from transfusion_torch.ops.nms import class_nms_multi


@dataclass(frozen=True)
class RPNConfig:
    pre_nms_top_n_test: int = 1000
    post_nms_top_n_test: int = 1000
    nms_thresh: float = 0.7
    score_thresh: float = 0.0
    min_size: float = 1e-3
    anchor_sizes: tuple = (32, 64, 128, 256, 512)
    aspect_ratios: tuple = (0.5, 1.0, 2.0)


class RPNHead(nn.Module):
    """3x3 conv + relu, then 1x1 objectness and 1x1 box deltas."""

    def __init__(self, channels: int = 256, num_anchors: int = 3, dtype=torch.float32):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)
        self.cls_logits = nn.Conv2d(channels, num_anchors, 1)
        self.bbox_pred = nn.Conv2d(channels, num_anchors * 4, 1)
        self.dtype = dtype

    def forward(self, feats: dict):
        objectness, deltas = {}, {}
        for key, f in feats.items():
            h = F.relu(conv(f, self.conv, self.dtype))
            objectness[key] = conv(h, self.cls_logits, self.dtype)
            deltas[key] = conv(h, self.bbox_pred, self.dtype)
        return objectness, deltas


def rpn_level_keys(feats: dict) -> list:
    """Every numbered map, then 'pool' (torchvision OrderedDict order)."""
    keys = sorted([k for k in feats if k.isdigit()], key=int)
    if "pool" in feats:
        keys.append("pool")
    return keys


def _flatten(x, last_dim: int):
    """[B, A*D, H, W] -> [B, H*W*A, D] in torch's (H, W, A) order."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1, last_dim)


def top_k_stable(x, k: int):
    """Descending top-k whose ties keep the lower index first (the order
    ``jax.lax.top_k`` gives)."""
    s = torch.sort(x, dim=-1, descending=True, stable=True)
    return s.values[..., :k], s.indices[..., :k]


def generate_proposals(objectness: dict, deltas: dict, image_hw, cfg: RPNConfig):
    """Decode + filter proposals; returns static-shape tensors (f32)."""
    keys = rpn_level_keys(objectness)
    shapes = tuple(tuple(objectness[k].shape[2:]) for k in keys)
    sizes = tuple(cfg.anchor_sizes[-len(keys):]) if len(keys) != 5 else tuple(cfg.anchor_sizes)
    anchors_np = grid_anchors(shapes, tuple(image_hw), sizes, tuple(cfg.aspect_ratios))
    dev = objectness[keys[0]].device

    coder = BoxCoder((1.0, 1.0, 1.0, 1.0))
    sel_boxes, sel_scores, sel_levels = [], [], []
    for lvl, (key, anch) in enumerate(zip(keys, anchors_np)):
        obj_l = _flatten(objectness[key], 1)[..., 0].float()
        dlt_l = _flatten(deltas[key], 4).float()
        bsz = obj_l.shape[0]
        k = min(cfg.pre_nms_top_n_test, anch.shape[0])
        top_scores, top_idx = top_k_stable(obj_l, k)
        top_deltas = torch.gather(dlt_l, 1, top_idx[..., None].expand(-1, -1, 4))
        top_anchors = torch.from_numpy(anch).to(dev)[top_idx]
        sel_boxes.append(coder.decode(top_deltas, top_anchors))
        sel_scores.append(top_scores)
        sel_levels.append(torch.full((bsz, k), lvl, dtype=torch.int64, device=dev))

    boxes = clip_boxes(torch.cat(sel_boxes, 1), image_hw[0], image_hw[1])
    scores = torch.sigmoid(torch.cat(sel_scores, 1))
    levels = torch.cat(sel_levels, 1)
    valid = small_box_mask(boxes, cfg.min_size) & (scores >= cfg.score_thresh)

    keep_idx, keep_valid = class_nms_multi(boxes, scores, levels, valid, cfg.nms_thresh,
                                           cfg.post_nms_top_n_test)
    proposals = torch.gather(boxes, 1, keep_idx[..., None].expand(-1, -1, 4))
    prop_scores = torch.gather(scores, 1, keep_idx)
    return {
        "boxes": torch.where(keep_valid[..., None], proposals, torch.zeros_like(proposals)),
        "scores": torch.where(keep_valid, prop_scores, torch.zeros_like(prop_scores)),
        "valid": keep_valid,
    }
