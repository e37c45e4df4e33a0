"""Training losses with static shapes (port of
``transfusion_tpu/train/losses.py:24-177``): smooth-L1 box loss (beta 1/9),
the torchvision RPN loss over a fixed per-image sample, the
class-weighted cross entropies of the reference trainer, the linear and
transformer TTC heads' smooth-L1 and the LM head's cross entropy. Every
function
takes validity masks: padded rows (label -1) drop out of the sums with the
normalisations the dynamic-shape reference computes. The RPN sampler takes
its uniform keys as ``draws`` (see :mod:`transfusion_torch.ops.matcher`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from transfusion_torch.models.roi_heads import IGNORE_VERB_IDX_BG
from transfusion_torch.ops.boxes import BoxCoder
from transfusion_torch.ops.matcher import balanced_sample_idx


def smooth_l1(x, beta: float):
    ax = x.abs()
    return torch.where(ax < beta, 0.5 * ax * ax / beta, ax - 0.5 * beta)


def box_loss(box_regression, noun_labels, reg_targets):
    """Smooth-L1 (beta 1/9) over positive rows' class-specific deltas,
    summed and divided by max(number of sampled rows, 1).
    box_regression [B, S, 4 C]; noun_labels [B, S] (-1 padding, 0 bg);
    reg_targets [B, S, 4]."""
    b, s, _ = box_regression.shape
    reg = box_regression.float().reshape(b, s, -1, 4)
    cls = torch.clamp(noun_labels, min=0)[..., None, None].expand(b, s, 1, 4)
    per_row = torch.gather(reg, 2, cls)[:, :, 0]
    losses = smooth_l1(per_row - reg_targets, 1.0 / 9.0).sum(-1)
    total = torch.where(noun_labels > 0, losses, 0.0).sum()
    return total / torch.clamp((noun_labels >= 0).sum(), min=1)


def rpn_loss(objectness, pred_deltas, labels, matches, anchors, gt_boxes, batch_size_per_image: int,
             draws, positive_fraction: float = 0.5):
    """torchvision RPN compute_loss on a fixed per-image sample of
    ``batch_size_per_image`` anchors drawn with ``draws`` (positive and
    negative keys [B, A]): (objectness BCE, smooth-L1 box loss), each summed
    over the sampled anchors of the batch and divided by their count.
    objectness [B, A], pred_deltas [B, A, 4], labels [B, A] in {1, 0, -1},
    matches [B, A], anchors [A, 4], gt_boxes [B, G, 4]."""
    idx, sampled_valid = balanced_sample_idx(labels, torch.ones_like(labels, dtype=torch.bool),
                                             draws, batch_size_per_image, positive_fraction)
    lab_s = torch.gather(labels, 1, idx)
    pos = sampled_valid & (lab_s > 0)
    idx4 = idx[..., None].expand(-1, -1, 4)
    matched_gt = torch.gather(gt_boxes.float(), 1,
                              torch.gather(matches, 1, idx)[..., None].expand(-1, -1, 4))
    reg_targets = BoxCoder((1.0, 1.0, 1.0, 1.0)).encode(matched_gt, anchors[idx])
    box = smooth_l1(torch.gather(pred_deltas, 1, idx4) - reg_targets, 1.0 / 9.0).sum(-1)
    logits = torch.gather(objectness, 1, idx)
    targets = (lab_s > 0).to(logits.dtype)
    bce = torch.clamp(logits, min=0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))
    denom = torch.clamp(sampled_valid.sum(), min=1)
    return (torch.where(sampled_valid, bce, 0.0).sum() / denom,
            torch.where(pos, box, 0.0).sum() / denom)


def weighted_cross_entropy(logits, targets, weights, valid):
    """torch CrossEntropyLoss(weight=w, reduction="mean") over valid rows:
    sum(w_t * nll) / sum(w_t)."""
    logp = F.log_softmax(logits.float(), dim=-1)
    t = torch.clamp(targets, min=0)
    nll = -torch.gather(logp, -1, t[..., None])[..., 0]
    w = weights.to(logp.device)[t] * valid.float()
    return (nll * w).sum() / torch.clamp(w.sum(), min=1e-12)


def noun_loss(class_logits, noun_labels, noun_weights):
    """Class-weighted noun CE over every sampled row, background included."""
    return weighted_cross_entropy(class_logits, noun_labels, noun_weights, noun_labels >= 0)


def verb_loss(verb_logits, verb_labels, verb_weights, verb_bg: bool):
    """Background verbs (code 999) map to the last class when ``verb_bg``,
    else their rows drop out."""
    is_bg = verb_labels == IGNORE_VERB_IDX_BG
    valid = verb_labels >= 0
    targets = torch.where(is_bg, verb_logits.shape[-1] - 1, verb_labels)
    if not verb_bg:
        valid = valid & ~is_bg
    return weighted_cross_entropy(verb_logits, targets, verb_weights, valid)


def ttc_loss(ttc_preds, ttc_targets, verb_labels, beta: float, ttc_bg: bool = False,
             ttc_bg_val: float = 0.0):
    """Smooth-L1 (beta) over rows whose verb target is not background (or
    over all valid rows with the background target ``ttc_bg_val``)."""
    is_bg = verb_labels == IGNORE_VERB_IDX_BG
    valid = verb_labels >= 0
    if ttc_bg:
        targets = torch.where(is_bg, ttc_bg_val, ttc_targets)
    else:
        targets = ttc_targets
        valid = valid & ~is_bg
    losses = smooth_l1(ttc_preds.float() - targets, beta)
    count = valid.sum()
    total = torch.where(valid, losses, 0.0).sum()
    return torch.where(count > 0, total / torch.clamp(count, min=1), 0.0)


def ttc_hand_loss(ttc_preds, det_valid, gt_ttcs, beta: float):
    """The transformer TTC head's criterion: each image's first GT TTC is
    repeated over its detections [B, K]; non-finite targets, invalid
    detections and negative (placeholder) predictions drop out; the
    smooth-L1 (beta) mean over what is left, 0 where nothing is."""
    tgt = gt_ttcs[:, :1].to(device=ttc_preds.device, dtype=torch.float32).expand(ttc_preds.shape)
    valid = det_valid & torch.isfinite(tgt) & (ttc_preds >= 0)
    losses = smooth_l1(ttc_preds.float() - torch.where(valid, tgt, 0.0), beta)
    count = valid.sum()
    total = torch.where(valid, losses, 0.0).sum()
    return torch.where(count > 0, total / torch.clamp(count, min=1), 0.0)


def lm_loss(lm_outputs, targets, last_noun_idx: int):
    """The LM auxiliary cross entropy: each image's first GT noun (the class
    moved to ``last_noun_idx`` maps back to 0) and first GT verb, clipped to
    the head's classes; the mean of the noun and verb CEs over images, in
    the logits' dtype, returned in f32."""
    def ce(logits, t):
        logp = F.log_softmax(logits, dim=-1)
        t = torch.clamp(t.to(logp.device).long(), 0, logp.shape[-1] - 1)
        return -torch.gather(logp, -1, t[:, None]).mean()

    noun_t = targets["nouns"][:, 0]
    l_n = ce(lm_outputs["noun_logits"], torch.where(noun_t == last_noun_idx, 0, noun_t))
    if lm_outputs.get("verb_logits") is None:
        return l_n.float()
    return ((l_n + ce(lm_outputs["verb_logits"], targets["verbs"][:, 0])) / 2.0).float()


def build_class_weights(noun_weights, verb_weights, bg_weight: float, verb_bg: bool,
                        all_class_w: bool):
    """Per-class weights with the background slot (noun index 0, verb
    appended last); the reference's ``abc_nao_trainer.py:32-54``."""
    n = np.asarray(noun_weights, np.float64).copy() if all_class_w else np.ones(len(noun_weights))
    v = np.asarray(verb_weights, np.float64).copy() if all_class_w else np.ones(len(verb_weights))
    if bg_weight != 1:
        n[0] = bg_weight
        if verb_bg:
            v = np.append(v, bg_weight)
    else:
        n[0] = n.mean()
        v = np.append(v, v.mean())
    return (torch.from_numpy(n.astype(np.float32)), torch.from_numpy(v.astype(np.float32)))
