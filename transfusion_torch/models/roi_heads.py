"""RoI box head, predictors, training-sample selection and static-shape
detection postprocess (port of ``transfusion_tpu/models/roi_heads.py``).
Names follow the reference:
``box_head.fc6``/``fc7`` (fc6 reads the pooled features flattened as
(C, y, x)), ``noun_classifier``, ``verb_classifier``, ``box_regressor.1``,
``ttc_pred_layer``."""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from transfusion_torch.models.rpn import top_k_stable
from transfusion_torch.models.text_encoder import dropout, linear
from transfusion_torch.ops.boxes import BoxCoder, box_iou, clip_boxes, small_box_mask
from transfusion_torch.ops.matcher import balanced_sample_idx, match_proposals
from transfusion_torch.ops.nms import class_nms_multi

IGNORE_VERB_IDX_BG = 999  # the background verb / ttc code of sampled rows


@dataclass(frozen=True)
class RoIConfig:
    num_nouns: int = 88
    num_verbs: int = 75
    representation_size: int = 1024
    fg_iou_thresh: float = 0.5
    bg_iou_thresh: float = 0.5
    batch_size_per_image: int = 128
    positive_fraction: float = 0.25
    score_thresh: float = 0.05
    nms_thresh: float = 0.5
    detections_per_img: int = 100
    min_size: float = 1e-2
    box_1_dropout: float = 0.0
    box_2_dropout: float = 0.0
    classif_dropout: float = 0.0
    ttc_on: bool = False
    additional_postprocessing: bool = False
    min_ttc: float = 0.251
    # Top-T candidates by score before NMS (exact while at most T clear the
    # threshold or the keep cap fills within them; 0 disables).
    pre_nms_candidates: int = 4096


BOX_CODER = BoxCoder((10.0, 10.0, 5.0, 5.0))


class BoxHead(nn.Module):
    """TwoMLPHead: flatten (C, y, x) -> fc6 -> relu -> fc7 -> relu."""

    def __init__(self, in_features: int, representation_size: int, dtype=torch.float32):
        super().__init__()
        self.fc6 = nn.Linear(in_features, representation_size)
        self.fc7 = nn.Linear(representation_size, representation_size)
        self.dtype = dtype

    def forward(self, pooled):
        """pooled [B, R, P, P, C] -> [B, R, representation]."""
        b, r = pooled.shape[:2]
        h = pooled.permute(0, 1, 4, 2, 3).reshape(b, r, -1)
        h = F.relu(linear(h, self.fc6, self.dtype))
        return F.relu(linear(h, self.fc7, self.dtype))


def predictors(heads, box_features, cfg: RoIConfig, dtype):
    """The reference's box_regressor / noun / verb / ttc heads over box
    features; ``heads`` is the module holding them (its training mode turns
    the box_2 / classif dropouts on)."""
    h = dropout(box_features, cfg.box_2_dropout, heads.training)
    box_regression = linear(h, heads.box_regressor[1], dtype)
    h = dropout(box_features, cfg.classif_dropout, heads.training)
    class_logits = linear(h, heads.noun_classifier, dtype)
    verb_logits = linear(h, heads.verb_classifier, dtype)
    ttcs = F.softplus(linear(h, heads.ttc_pred_layer, dtype))[..., 0] if cfg.ttc_on else None
    return {
        "class_logits": class_logits,
        "verb_logits": verb_logits,
        "box_regression": box_regression,
        "ttcs": ttcs,
        "box_features": h,
    }


class RoIHeads(nn.Module):
    """``roi_heads``: BoxHead + RoIPredictors."""

    def __init__(self, cfg: RoIConfig, in_features: int, dtype=torch.float32):
        super().__init__()
        rep = cfg.representation_size
        self.cfg, self.dtype = cfg, dtype
        self.box_head = BoxHead(in_features, rep, dtype)
        self.box_regressor = nn.Sequential(nn.Identity(), nn.Linear(rep, 4 * cfg.num_nouns))
        self.noun_classifier = nn.Linear(rep, cfg.num_nouns)
        self.verb_classifier = nn.Linear(rep, cfg.num_verbs)
        if cfg.ttc_on:
            self.ttc_pred_layer = nn.Linear(rep, 1)

    def forward(self, pooled):
        return predictors(self, self.box_head(pooled), self.cfg, self.dtype)


def _take(x, idx):
    return torch.gather(x, 1, idx)


def select_training_samples(proposals, prop_valid, targets: dict, cfg: RoIConfig, draws):
    """A fixed set of S = batch_size_per_image training RoIs per image with
    triple labels: the GT boxes are appended to the proposals, matched by IoU
    (fg/bg thresholds), background rows get noun 0 / verb 999 / ttc 999 and
    between-threshold rows -1, then positives and negatives are sampled with
    ``draws`` (positive keys, negative keys) [B, P + G]. Returns [B, S, ...]
    rois, nouns, verbs, ttcs, reg_targets and valid; padding slots carry
    labels -1 and zeros."""
    s = cfg.batch_size_per_image
    boxes = targets["boxes"].float()
    gvalid = targets["valid"].bool()
    all_props = torch.cat([proposals.detach().float(), boxes], 1)
    all_valid = torch.cat([prop_valid, gvalid], 1)
    iou = box_iou(boxes, all_props)
    iou = torch.where(all_valid[:, None, :], iou, torch.full_like(iou, -1.0))
    matches = match_proposals(iou, gvalid, cfg.fg_iou_thresh, cfg.bg_iou_thresh, False)
    clamped = torch.clamp(matches, min=0)
    fg, bg = matches >= 0, matches == -1

    def label(values, bg_code, fill):
        x = torch.where(fg, _take(values, clamped), torch.where(bg, bg_code, fill).to(values.dtype))
        return torch.where(gvalid.any(-1, keepdim=True), x, torch.full_like(x, bg_code))

    noun_l = label(targets["nouns"].long(), 0, -1)
    verb_l = label(targets["verbs"].long(), IGNORE_VERB_IDX_BG, -1)
    ttc_l = label(targets["ttcs"].float(), float(IGNORE_VERB_IDX_BG), -1.0)
    noun_l = torch.where(all_valid, noun_l, -1)

    order, sampled_valid = balanced_sample_idx(noun_l, all_valid, draws, s, cfg.positive_fraction)
    rois = torch.gather(all_props, 1, order[..., None].expand(-1, -1, 4))
    matched_gt = torch.gather(boxes, 1, _take(clamped, order)[..., None].expand(-1, -1, 4))
    reg_targets = BOX_CODER.encode(matched_gt, rois)
    v4 = sampled_valid[..., None]
    return {
        "rois": torch.where(v4, rois, torch.zeros_like(rois)),
        "nouns": torch.where(sampled_valid, _take(noun_l, order), -1),
        "verbs": torch.where(sampled_valid, _take(verb_l, order), -1),
        "ttcs": torch.where(sampled_valid, _take(ttc_l, order), -1.0),
        "reg_targets": torch.where(v4, reg_targets, torch.zeros_like(reg_targets)),
        "valid": sampled_valid,
    }


def postprocess_detections(outputs: dict, proposals, prop_valid, image_hw, cfg: RoIConfig,
                           noun_verb_frequencies=None):
    """Per-image top-k detections [B, K, ...] (K = detections_per_img), eval:
    boxes, scores, nouns, verbs, ttcs, prop_idx, valid, pre_nms_missed."""
    f32 = lambda x: None if x is None else x.float()  # noqa: E731
    class_logits = f32(outputs["class_logits"])
    verb_logits = f32(outputs["verb_logits"])
    box_regression = f32(outputs["box_regression"])
    ttcs = f32(outputs["ttcs"])
    proposals = f32(proposals)
    bsz, r, c = class_logits.shape
    dev = class_logits.device

    pred_boxes = BOX_CODER.decode(box_regression.reshape(bsz, r, c, 4), proposals)
    pred_boxes = clip_boxes(pred_boxes, image_hw[0], image_hw[1])
    scores = torch.softmax(class_logits, dim=-1)
    verb_idx = torch.argmax(verb_logits[..., :-1], dim=-1)
    if ttcs is None:
        ttcs = torch.zeros((bsz, r), device=dev)

    cand_boxes = pred_boxes[:, :, 1:, :].reshape(bsz, r * (c - 1), 4)
    cand_scores = scores[:, :, 1:].reshape(bsz, r * (c - 1))
    cand_labels = torch.arange(1, c, device=dev)[None, None, :].expand(bsz, r, c - 1).reshape(bsz, -1)
    cand_prop = torch.arange(r, device=dev)[None, :, None].expand(bsz, r, c - 1).reshape(bsz, -1)
    valid = (
        prop_valid[:, :, None].expand(bsz, r, c - 1).reshape(bsz, -1)
        & (cand_scores > cfg.score_thresh)
        & small_box_mask(cand_boxes, cfg.min_size)
    )

    t = cfg.pre_nms_candidates
    pre_nms_missed = torch.zeros((bsz,), dtype=torch.int64, device=dev)
    if t and t < cand_scores.shape[1]:
        pre_nms_missed = torch.clamp(valid.sum(1) - t, min=0)
        top_scores, top_idx = top_k_stable(
            torch.where(valid, cand_scores, torch.full_like(cand_scores, float("-inf"))), t)
        cand_boxes = torch.gather(cand_boxes, 1, top_idx[..., None].expand(-1, -1, 4))
        finite = torch.isfinite(top_scores)
        cand_scores = torch.where(finite, top_scores, torch.zeros_like(top_scores))
        cand_labels = _take(cand_labels, top_idx)
        cand_prop = _take(cand_prop, top_idx)
        valid = finite

    k = cfg.detections_per_img
    keep_idx, keep_valid = class_nms_multi(cand_boxes, cand_scores, cand_labels, valid,
                                           cfg.nms_thresh, k)
    det_boxes = torch.gather(cand_boxes, 1, keep_idx[..., None].expand(-1, -1, 4))
    det_scores = _take(cand_scores, keep_idx)
    det_nouns = _take(cand_labels, keep_idx)
    det_prop = _take(cand_prop, keep_idx)
    det_verbs = _take(verb_idx, det_prop)
    det_ttcs = _take(ttcs, det_prop)

    if cfg.additional_postprocessing and noun_verb_frequencies is not None:
        freqs = noun_verb_frequencies.to(device=dev, dtype=torch.float32)
        det_freq_row = freqs[det_nouns]                                  # [B, K, V]
        argmax_verbs = torch.argmax(det_freq_row, dim=-1)
        argmax_freq = torch.gather(det_freq_row, 2, argmax_verbs[..., None])[..., 0]
        cur_freq = torch.gather(det_freq_row, 2, det_verbs[..., None])[..., 0]
        replace = (cur_freq == 0) & (argmax_freq > 0)
        det_verbs = torch.where(replace, argmax_verbs, det_verbs)

        # Greedy suppression of intersecting same-(noun, verb) detections:
        # detection i dies if any earlier detection conflicts with it.
        xl = torch.maximum(det_boxes[:, :, None, 0], det_boxes[:, None, :, 0])
        yt = torch.maximum(det_boxes[:, :, None, 1], det_boxes[:, None, :, 1])
        xr = torch.minimum(det_boxes[:, :, None, 2], det_boxes[:, None, :, 2])
        yb = torch.minimum(det_boxes[:, :, None, 3], det_boxes[:, None, :, 3])
        intersect = (xl < xr) & (yt < yb)
        same = (det_nouns[:, :, None] == det_nouns[:, None, :]) & (
            det_verbs[:, :, None] == det_verbs[:, None, :])
        both_valid = keep_valid[:, :, None] & keep_valid[:, None, :]
        eye = torch.eye(k, dtype=torch.bool, device=dev)[None]
        lower = torch.tril(torch.ones((k, k), dtype=torch.bool, device=dev))[None]
        conflicts = intersect & same & both_valid & ~eye
        keep_valid = keep_valid & ((conflicts & lower).sum(-1) == 0)
        det_ttcs = torch.clamp(det_ttcs, min=cfg.min_ttc)

    zf = lambda x: torch.where(keep_valid if x.dim() == 2 else keep_valid[..., None],  # noqa: E731
                               x, torch.zeros_like(x))
    return {
        "boxes": zf(det_boxes),
        "scores": zf(det_scores),
        "nouns": zf(det_nouns),
        "verbs": zf(det_verbs),
        "ttcs": zf(det_ttcs),
        "prop_idx": det_prop,
        "valid": keep_valid,
        "pre_nms_missed": pre_nms_missed,
    }
