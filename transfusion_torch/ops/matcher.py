"""Proposal-to-GT matching and balanced sampling with static shapes (port of
``transfusion_tpu/ops/matcher.py``): torchvision ``Matcher`` and
``BalancedPositiveNegativeSampler`` semantics as fixed-size index lists.

The random draw is separate from the selection. A selection takes uniform
keys in [0, 1) as tensors (one per candidate, a positive and a negative set
per image) and picks, within each class, the candidates with the largest
keys. :func:`uniform_draws` makes the keys from an explicit
``torch.Generator``; the tests instead pass in the exact arrays the JAX
package draws (``jax.random.uniform`` under its key chain), since torch
cannot reproduce that stream, and so get slot-for-slot parity.
"""

from __future__ import annotations

import torch

BELOW_LOW_THRESHOLD = -1
BETWEEN_THRESHOLDS = -2


def match_proposals(iou, gt_valid, high_thresh: float, low_thresh: float,
                    allow_low_quality: bool = False):
    """iou [..., G, N] of gt x proposals, gt_valid [..., G] -> matches [..., N]
    int64: the GT index, or BELOW_LOW_THRESHOLD / BETWEEN_THRESHOLDS. Ties
    take the first GT, as ``jnp.argmax`` does."""
    iou = torch.where(gt_valid[..., :, None], iou, torch.full_like(iou, -1.0))
    matched_vals = iou.amax(dim=-2)
    matches = torch.argmax(iou, dim=-2)
    out = torch.where(matched_vals < low_thresh, BELOW_LOW_THRESHOLD, matches)
    between = (matched_vals >= low_thresh) & (matched_vals < high_thresh)
    out = torch.where(between, BETWEEN_THRESHOLDS, out)
    if allow_low_quality:
        # Every prediction tied for a GT's best IoU keeps its argmax match
        # (torchvision set_low_quality_matches_).
        best_per_gt = iou.amax(dim=-1, keepdim=True)
        is_best = (iou == best_per_gt) & gt_valid[..., :, None] & (best_per_gt > 0)
        out = torch.where(is_best.any(dim=-2), matches, out)
    return out


def uniform_draws(shape, generator: torch.Generator | None = None, device=None, rows=None):
    """(positive keys, negative keys), each uniform [0, 1) of ``shape``, from
    ``generator`` (on its device) or torch's default generator. ``rows``
    (start, stop, total): the draws of a global batch of ``total`` rows,
    cut to rows start:stop (a rank's slice in data parallelism)."""
    if generator is not None:
        device = generator.device
    if rows is None:
        return tuple(torch.rand(shape, generator=generator, device=device) for _ in range(2))
    full = (rows[2], *tuple(shape)[1:])
    return tuple(torch.rand(full, generator=generator, device=device)[rows[0]:rows[1]]
                 for _ in range(2))


def _sample_parts(labels, valid, draws, batch_size: int, positive_fraction: float):
    """Per row of [..., N]: the positive and negative picks (take mask, index)
    of the largest keys among each class (``_sample_parts`` of the JAX
    package, whose ``approx_max_k`` is exact at recall 1)."""
    is_pos = (labels >= 1) & valid
    is_neg = (labels == 0) & valid
    num_pos_target = int(batch_size * positive_fraction)
    num_pos = torch.clamp(is_pos.sum(-1), max=num_pos_target)
    num_neg = torch.minimum(is_neg.sum(-1), batch_size - num_pos)
    n = labels.shape[-1]

    def pick(mask, keys, kmax, count):
        kk = min(kmax, n)
        vals, idx = torch.topk(torch.where(mask, keys, torch.full_like(keys, -1.0)), kk, dim=-1)
        take = (torch.arange(kk, device=labels.device) < count[..., None]) & (vals >= 0.0)
        return take, idx

    pos_take, idx_p = pick(is_pos, draws[0], num_pos_target, num_pos)
    neg_take, idx_n = pick(is_neg, draws[1], batch_size, num_neg)
    return pos_take, idx_p, neg_take, idx_n


def balanced_sample(labels, valid, draws, batch_size: int, positive_fraction: float):
    """labels [..., N] (>0 positive, 0 negative, <0 ignored), valid [..., N];
    draws (positive keys, negative keys) [..., N]. Returns (pos_mask,
    neg_mask) bool [..., N]: min(num_pos, batch * fraction) positives and up
    to batch - positives negatives."""
    pos_take, idx_p, neg_take, idx_n = _sample_parts(labels, valid, draws, batch_size,
                                                     positive_fraction)
    pos_mask = torch.zeros_like(valid).scatter(-1, idx_p, pos_take)
    neg_mask = torch.zeros_like(valid).scatter(-1, idx_n, neg_take)
    return pos_mask, neg_mask


def balanced_sample_idx(labels, valid, draws, batch_size: int, positive_fraction: float):
    """Index form: (idx, sampled_valid), each [..., batch_size], positives
    first, then negatives, padding slots False."""
    pos_take, idx_p, neg_take, idx_n = _sample_parts(labels, valid, draws, batch_size,
                                                     positive_fraction)
    num_pos = pos_take.sum(-1, keepdim=True)
    j = torch.arange(batch_size, device=labels.device)
    from_pos = j < num_pos
    pos_src = torch.clamp(j, 0, idx_p.shape[-1] - 1).expand_as(from_pos)
    neg_src = torch.clamp(j - num_pos, 0, idx_n.shape[-1] - 1)
    idx = torch.where(from_pos, torch.gather(idx_p, -1, pos_src), torch.gather(idx_n, -1, neg_src))
    sampled_valid = from_pos | ((j - num_pos) < neg_take.sum(-1, keepdim=True))
    return idx, sampled_valid
