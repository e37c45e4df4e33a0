"""Training losses with static shapes (port of
``transfusion_tpu/train/losses.py:24-291``): smooth-L1 box loss (beta 1/9),
the torchvision RPN loss over a fixed per-image sample, the
class-weighted cross entropies of the reference trainer, the linear and
transformer TTC heads' smooth-L1, the LM head's cross entropy, and the
legacy heatmap family's criteria (``hmap_criterion``, ``multivar_n_loss``).
Every detector loss takes validity masks: padded rows (label -1) drop out of the sums with the
normalisations the dynamic-shape reference computes. The RPN sampler takes
its uniform keys as ``draws`` (see :mod:`transfusion_torch.ops.matcher`).

Each normaliser (a count or a weight sum over the batch) goes through
``reduce`` when one is given: in data parallelism the sum over the ranks
(``parallel.mesh.global_sum``), so a rank's loss is its share of the
global batch's loss and the ranks' losses and gradients add up to the
one-rank run's, as the JAX package's losses over a data-sharded batch do.
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


def _den(x, reduce):
    return x if reduce is None else reduce(x)


def box_loss(box_regression, noun_labels, reg_targets, reduce=None):
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
    return total / torch.clamp(_den((noun_labels >= 0).sum(), reduce), min=1)


def rpn_loss(objectness, pred_deltas, labels, matches, anchors, gt_boxes, batch_size_per_image: int,
             draws, positive_fraction: float = 0.5, reduce=None):
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
    denom = torch.clamp(_den(sampled_valid.sum(), reduce), min=1)
    return (torch.where(sampled_valid, bce, 0.0).sum() / denom,
            torch.where(pos, box, 0.0).sum() / denom)


def weighted_cross_entropy(logits, targets, weights, valid, reduce=None):
    """torch CrossEntropyLoss(weight=w, reduction="mean") over valid rows:
    sum(w_t * nll) / sum(w_t)."""
    logp = F.log_softmax(logits.float(), dim=-1)
    t = torch.clamp(targets, min=0)
    nll = -torch.gather(logp, -1, t[..., None])[..., 0]
    w = weights.to(logp.device)[t] * valid.float()
    return (nll * w).sum() / torch.clamp(_den(w.sum(), reduce), min=1e-12)


def noun_loss(class_logits, noun_labels, noun_weights, reduce=None):
    """Class-weighted noun CE over every sampled row, background included."""
    return weighted_cross_entropy(class_logits, noun_labels, noun_weights, noun_labels >= 0, reduce)


def verb_loss(verb_logits, verb_labels, verb_weights, verb_bg: bool, reduce=None):
    """Background verbs (code 999) map to the last class when ``verb_bg``,
    else their rows drop out."""
    is_bg = verb_labels == IGNORE_VERB_IDX_BG
    valid = verb_labels >= 0
    targets = torch.where(is_bg, verb_logits.shape[-1] - 1, verb_labels)
    if not verb_bg:
        valid = valid & ~is_bg
    return weighted_cross_entropy(verb_logits, targets, verb_weights, valid, reduce)


def ttc_loss(ttc_preds, ttc_targets, verb_labels, beta: float, ttc_bg: bool = False,
             ttc_bg_val: float = 0.0, reduce=None):
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
    count = _den(valid.sum(), reduce)
    total = torch.where(valid, losses, 0.0).sum()
    return torch.where(count > 0, total / torch.clamp(count, min=1), 0.0)


def ttc_hand_loss(ttc_preds, det_valid, gt_ttcs, beta: float, reduce=None):
    """The transformer TTC head's criterion: each image's first GT TTC is
    repeated over its detections [B, K]; non-finite targets, invalid
    detections and negative (placeholder) predictions drop out; the
    smooth-L1 (beta) mean over what is left, 0 where nothing is."""
    tgt = gt_ttcs[:, :1].to(device=ttc_preds.device, dtype=torch.float32).expand(ttc_preds.shape)
    valid = det_valid & torch.isfinite(tgt) & (ttc_preds >= 0)
    losses = smooth_l1(ttc_preds.float() - torch.where(valid, tgt, 0.0), beta)
    count = _den(valid.sum(), reduce)
    total = torch.where(valid, losses, 0.0).sum()
    return torch.where(count > 0, total / torch.clamp(count, min=1), 0.0)


def lm_loss(lm_outputs, targets, last_noun_idx: int, reduce=None):
    """The LM auxiliary cross entropy: each image's first GT noun (the class
    moved to ``last_noun_idx`` maps back to 0) and first GT verb, clipped to
    the head's classes; the mean of the noun and verb CEs over images, in
    the logits' dtype, returned in f32."""
    def ce(logits, t):
        logp = F.log_softmax(logits, dim=-1)
        t = torch.clamp(t.to(logp.device).long(), 0, logp.shape[-1] - 1)
        nll = -torch.gather(logp, -1, t[:, None])
        if reduce is None:
            return nll.mean()
        n = reduce(torch.tensor(float(nll.numel()), device=logp.device))
        return nll.sum() / n.to(nll.dtype)

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


# --------------------------------------------------- the legacy heatmap family
def hmap_criterion(criterion: dict, pixel_w):
    """Heatmap loss factory of the legacy snao family (``get_hmap_criterion``
    + ``w_loss``, runner/metrics_losses/losses.py:25-42,69-98; port of
    ``transfusion_tpu/train/losses.py::hmap_criterion``).

    Returns ``fn(preds, targets, fg_perc=None, bg_perc=None) -> scalar`` in
    f32. The first of mae, smooth_mae, mse, ce / focal (both
    BCE-with-logits, as the reference builds them), kl_div present in
    ``criterion`` picks the elementwise loss (mae when none is). ``pixel_w``
    reweights foreground (target > 0) against background pixels: a scalar
    ``w`` as fg 1 - 1/(1+w), bg 1/(1+w); ``"reg"`` by the per-sample
    (1 - fg_perc) and (1 - bg_perc). ``agg == "sum"`` sums each image's
    pixels and means over the batch; anything else is a plain mean.
    ``kl_div`` is torch's ``KLDivLoss`` elementwise, ``target * (log(target)
    - pred)`` with ``pred`` log-probabilities, 0 where target == 0."""
    agg = criterion.get("agg", "mean")

    if criterion.get("mae", 0):
        def base(p, t):
            return (p - t).abs()
    elif criterion.get("smooth_mae", 0):
        def base(p, t):
            return smooth_l1(p - t, 1.0)
    elif "mse" in criterion:
        def base(p, t):
            return (p - t) ** 2
    elif "ce" in criterion or "focal" in criterion:
        def base(p, t):
            return torch.clamp(p, min=0) - p * t + torch.log1p(torch.exp(-p.abs()))
    elif "kl_div" in criterion:
        def base(p, t):
            pos = t > 0
            return torch.where(pos, t * (torch.log(torch.where(pos, t, 1.0)) - p), 0.0)
    else:
        def base(p, t):
            return (p - t).abs()

    weighted = pixel_w != 1
    if weighted and pixel_w != "reg":
        fg_w, bg_w = 1.0 - 1.0 / (1.0 + pixel_w), 1.0 / (1.0 + pixel_w)

    def apply(preds, targets, fg_perc=None, bg_perc=None):
        bs = preds.shape[0]
        losses = base(preds.float(), targets.float()).reshape(bs, -1)
        fg = targets.reshape(bs, -1) > 0
        if pixel_w == "reg":
            losses = torch.where(fg, losses * (1.0 - fg_perc.float())[:, None],
                                 losses * (1.0 - bg_perc.float())[:, None])
        elif weighted:
            losses = torch.where(fg, losses * fg_w, losses * bg_w)
        if agg == "sum":
            return losses.sum(-1).mean()
        return losses.mean()

    return apply


def heatmap_uniforms(shape, generator: torch.Generator, device=None):
    """Uniforms in [1e-12, 1) as ``jax.random.uniform(key, shape,
    minval=1e-12, maxval=1.0)`` spreads them (in f32 the width 1 - 1e-12 is
    1), drawn from ``generator`` on its device."""
    u = torch.rand(shape, generator=generator, device=device or generator.device)
    return torch.clamp(u + 1e-12, min=1e-12)


def sample_heatmap_coords(gt_heatmap, no_samples: int, generator: torch.Generator | None = None,
                          uniforms=None):
    """``no_samples`` distinct pixels a heatmap [B, H, W] weighted by its
    mass, without replacement (the Gumbel-top-k trick: keys log(mass) +
    Gumbel noise, zero-mass pixels at -inf), mapped to the multivar frame:
    y to [-MAX_STD*h/w, MAX_STD*h/w], x to [-MAX_STD, MAX_STD]. Returns
    [B, no_samples, 2] as (y, x). The noise comes from ``uniforms`` [B, H*W]
    (as ``jax.random.uniform`` draws them) or from ``generator``. Equal keys
    go to the lower pixel index first, as ``lax.top_k`` takes them: a
    stable descending sort (an image with fewer nonzero pixels than
    ``no_samples`` fills its tail with the lowest zero-mass indices)."""
    from transfusion_torch.data.heatmaps import MAX_STD

    b, h, w = gt_heatmap.shape
    flat = gt_heatmap.reshape(b, h * w).float()
    logw = torch.where(flat > 0, torch.log(torch.clamp(flat, min=1e-30)), -torch.inf)
    if uniforms is None:
        if generator is None:
            raise ValueError("sample_heatmap_coords draws from a torch.Generator: pass generator or uniforms")
        uniforms = heatmap_uniforms(flat.shape, generator, flat.device)
    gumbel = -torch.log(-torch.log(uniforms.to(flat.device, torch.float32)))
    idx = torch.sort(logw + gumbel, dim=-1, descending=True, stable=True).indices[:, :no_samples]
    ys = torch.div(idx, w, rounding_mode="floor").float()
    xs = (idx % w).float()
    sy = h / w
    ys = ys / h * (2 * MAX_STD * sy) - MAX_STD * sy
    xs = xs / w * (2 * MAX_STD) - MAX_STD
    return torch.stack([ys, xs], dim=-1)


def mvn_nll(loc, scale_tril, samples):
    """Mean negative log-likelihood of ``samples`` [B, S, 2] under the 2-D
    Gaussian N(loc, L L^T), the 2x2 lower-triangular solve written out."""
    d = (samples - loc[:, None, :]).float()
    l00, l10, l11 = (scale_tril[:, i, j][:, None].float() for i, j in ((0, 0), (1, 0), (1, 1)))
    z0 = d[..., 0] / l00
    z1 = (d[..., 1] - l10 * z0) / l11
    logdet = torch.log(l00.abs()) + torch.log(l11.abs())
    logp = -0.5 * (z0 ** 2 + z1 ** 2) - logdet - float(np.log(2 * np.pi))
    return -logp.mean()


def multivar_n_loss(criterion: dict):
    """``multivar_n_loss`` (runner/metrics_losses/losses.py:44-63): draw
    ``criterion["no_samples"]`` heatmap-weighted coordinates and score them
    under the predicted Gaussian ``dist`` ({"loc", "scale_tril"}, the
    model's output under ``multivar_n``). Returns ``fn(dist, gt_heatmap,
    generator=None, uniforms=None)``."""
    no_samples = criterion["no_samples"]

    def loss(dist, gt_heatmap, generator=None, uniforms=None):
        samples = sample_heatmap_coords(gt_heatmap, no_samples, generator, uniforms)
        return mvn_nll(dist["loc"], dist["scale_tril"], samples)

    return loss
