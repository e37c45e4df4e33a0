"""The train and eval steps (port of ``transfusion_tpu/train/step.py``):
forward with target assignment and RoI sampling, the 6-slot criterion of the
reference trainer, backward, the optimizer chain of :mod:`.optim`, and the
epoch freeze multipliers, with the non-finite guard; the eval step (forward
and postprocess, then the transformer TTC head's pass where the model has
it) and the eval step with validation losses.

Mixed precision: parameters stay f32 and every module casts them to the
compute dtype at use (bf16 on the flagship). Autograd therefore forms each
weight gradient of a >= 2-D parameter in bf16, the cast's backward widens it
to f32, and the optimizer state and update stay f32: the
``bf16_grads=True`` path of ``bench.py:349`` (``to_bf16_grads_view``), by
construction. Biases and norm scales are used in f32 where JAX keeps them
f32.

Randomness is a function of (seed, step), as JAX folds the step into its
key, so a resumed run replays its steps: the RoI and RPN samplers take
uniform keys (``draws``) from an explicit ``torch.Generator`` seeded by
(seed, step) unless the caller passes them, as the parity tests pass JAX's;
dropout draws from the step's ``DropoutRNG`` (keep masks on the model's
device, attention-kernel seeds from a CPU generator). The eval step with
losses samples from fixed generators (seeds 0 and 1, as JAX's ``key(0)`` and
``key(1)``), so every call draws the same keys.

Data parallelism (a process group of R ranks, each with a contiguous slice
of the global batch) gives the one-rank result, as JAX's data-sharded
``jit`` does: every draw is made for the global batch and cut to the
rank's rows (``rows``), the losses' normalisers and the trainable
BatchNorm's statistics are summed over the ranks, the gradients are summed
(all-reduce, or reduce-scatter onto shards under FSDP:
:class:`~transfusion_torch.parallel.fsdp.Sharding`) before the
multipliers, the optimizer and the non-finite guard, and the guard's
verdict and the logged losses are the global ones.

Trainable BatchNorm's running averages live in the model's buffers;
``TrainState.batch_stats`` names them, and a skipped (non-finite) step
puts back the values they had before its forward, as JAX keeps the old
``batch_stats`` (step.py:246).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from transfusion_torch.models.detector import detections_from_outputs
from transfusion_torch.models.resnet import batch_stats
from transfusion_torch.models.text_encoder import DropoutRNG
from transfusion_torch.ops.matcher import uniform_draws
from transfusion_torch.parallel.fsdp import Sharding
from transfusion_torch.parallel.mesh import batch_rows, global_sum, world_size
from transfusion_torch.train import losses as L
from transfusion_torch.train.optim import attach_sharding


@dataclass(frozen=True)
class LossConfig:
    """Static criterion switches (run.criterion + run flags)."""

    bbox_on: bool = True
    obj_prop_on: bool = True
    noun_on: bool = True
    verb_on: bool = True
    ttc_on: bool = False
    lm_on: bool = False
    agg_mean: bool = True
    ttc_beta: float = 1.0
    verb_bg: bool = True
    ttc_bg: bool = False
    ttc_bg_val: float = 0.0
    rpn_batch_size_per_image: int = 256
    last_noun_idx: int = 0


@dataclass
class TrainState:
    """The step count and the optimizer state; the parameters live in the
    model, and so do the trainable BatchNorms' running averages, which
    ``batch_stats`` names ({name: the live buffer}; None without them)."""

    step: int
    opt_state: dict
    seed: int = 0
    batch_stats: dict | None = None


def compute_losses(outputs, batch, loss_cfg: LossConfig, noun_w, verb_w, rpn_draws, reduce=None):
    """(stacked losses [6] = [bbox, obj_prop, noun, verb, ttc, lm], metrics);
    ``reduce`` sums each normaliser over the ranks (see :mod:`.losses`)."""
    roi = outputs["roi_outputs"]
    nouns, verbs, ttcs_t = roi["labels"]
    dev = roi["class_logits"].device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    bbox = obj_l = rpn_box_l = zero
    if loss_cfg.bbox_on:
        bbox = L.box_loss(roi["box_regression"], nouns, roi["reg_targets"], reduce)
    if loss_cfg.obj_prop_on:
        prop = outputs["proposals"]
        obj_l, rpn_box_l = L.rpn_loss(
            prop["objectness"], prop["pred_bbox_deltas"], prop["labels"], prop["matches"],
            prop["anchors"], batch["targets"]["boxes"].to(dev), loss_cfg.rpn_batch_size_per_image,
            rpn_draws, reduce=reduce)
    noun_l = L.noun_loss(roi["class_logits"], nouns, noun_w, reduce) if loss_cfg.noun_on else zero
    verb_l = (L.verb_loss(roi["verb_logits"], verbs, verb_w, loss_cfg.verb_bg, reduce)
              if loss_cfg.verb_on else zero)
    if loss_cfg.ttc_on and "ttc_hand" in outputs:
        # The transformer TTC head's second pass.
        th = outputs["ttc_hand"]
        ttc_l = L.ttc_hand_loss(th["ttcs"], th["valid"], batch["targets"]["ttcs"], loss_cfg.ttc_beta,
                                reduce)
    elif loss_cfg.ttc_on:
        ttc_l = L.ttc_loss(roi["ttcs"], ttcs_t, verbs, loss_cfg.ttc_beta, loss_cfg.ttc_bg,
                           loss_cfg.ttc_bg_val, reduce)
    else:
        ttc_l = zero
    lm_l = (L.lm_loss(outputs["lm"], batch["targets"], loss_cfg.last_noun_idx, reduce)
            if loss_cfg.lm_on else zero)
    stacked = torch.stack([bbox, obj_l + rpn_box_l, noun_l, verb_l, ttc_l, lm_l])
    metrics = {"bbox_loss": bbox, "objectness_loss": obj_l, "loss_rpn_box_reg": rpn_box_l,
               "noun_loss": noun_l, "verb_loss": verb_l, "ttc_loss": ttc_l, "lm_loss": lm_l}
    return stacked, metrics


def criterion_weights(criterion: dict, epoch: int = 0):
    """The 6-slot [bbox, obj_prop, noun, verb, ttc, lm] weights for an epoch:
    raw weights, the RPN terms under the bbox weight gated by obj_prop and
    decayed by obj_prop_rate per epoch, the lm weight decayed by lm_decay."""
    bbox_w = criterion.get("bbox", 0)
    lm_w = criterion.get("lm", 0)
    lm_decay = criterion.get("lm_decay", 0)
    if lm_decay:
        lm_w = lm_w * lm_decay ** epoch
    obj_w = bbox_w * criterion.get("obj_prop", 0) * criterion.get("obj_prop_rate", 1) ** epoch
    return np.array([bbox_w, obj_w, criterion.get("noun", 0), criterion.get("verb", 0),
                     criterion.get("ttc", 0), lm_w], np.float32)


def normalized_criterion_weights(criterion: dict):
    """The validation weights [bbox, noun, verb, ttc, lm], normalised to sum 1."""
    w = np.array([criterion.get(k, 0) for k in ("bbox", "noun", "verb", "ttc", "lm")], np.float32)
    s = w.sum()
    return w / s if s > 0 else w


def step_generator(device, seed: int, step: int) -> torch.Generator:
    """The explicit generator of one step's sampler draws."""
    return torch.Generator(device=device).manual_seed(seed * 1_000_003 + step)


def _cut(draws, rows):
    """A rank's rows of global draws ((pos, neg) [total, ...])."""
    return None if draws is None else tuple(d[rows[0]:rows[1]] for d in draws)


def _global_metrics(metrics: dict) -> dict:
    """Each loss summed over the ranks (each rank's is its share of the
    global batch's), in one collective."""
    if world_size() == 1:
        return metrics
    summed = global_sum(torch.stack([v.detach().float() for v in metrics.values()]))
    return dict(zip(metrics, summed))


def make_train_step(model, tx, loss_cfg: LossConfig, noun_w, verb_w, sharding: Sharding | None = None):
    """Returns ``step_fn(state, batch, loss_w, update_mult=None, draws=None)
    -> metrics``, which updates the model's parameters and ``state`` in
    place. ``loss_w`` is the 6-slot criterion weight vector; ``update_mult``
    a {name: 0/1} map that masks both the gradients (so frozen moments stay
    zero) and the updates (so weight decay cannot move frozen parameters);
    ``draws`` {"roi": (pos, neg) [B, P + G], "rpn": (pos, neg) [B, A]}
    replaces the step's sampler draws (for the global batch under data
    parallelism). ``sharding`` (default: every parameter replicated) says
    how the ranks hold the parameters; the optimizer state must be
    ``tx.init(sharding.views())``."""
    params = dict(model.named_parameters())
    names = list(params)
    sharding = sharding if sharding is not None else Sharding(model)
    attach_sharding(tx, sharding)
    opt_params = sharding.views()
    opt_tensors = list(opt_params.values())
    dev = model.device
    noun_w, verb_w = torch.as_tensor(noun_w, device=dev), torch.as_tensor(verb_w, device=dev)
    zeros: dict = {}  # read-only zero gradients, made on first need
    stats = batch_stats(model)

    def grad_or_zeros(k, p, reduced: bool):
        if p.grad is not None:
            return p.grad
        if reduced:  # summed in place over the ranks: its own tensor
            return torch.zeros_like(p)
        z = zeros.get(k)
        if z is None:
            z = zeros[k] = torch.zeros_like(p)
        return z

    def step_fn(state: TrainState, batch, loss_w, update_mult=None, draws=None):
        model.train()
        for p in params.values():
            p.grad = None
        world = world_size()
        reduce = global_sum if world > 1 else None
        rows = batch_rows(batch["image"].shape[0])
        gen = step_generator(dev, state.seed, state.step)
        draws = draws or {}
        before = None if stats is None else [t.clone() for t in stats.values()]
        outputs = model(batch, train=True, draws=_cut(draws.get("roi"), rows), generator=gen,
                        rng=DropoutRNG(dev, state.seed, state.step, rows), rows=rows)
        rpn_draws = _cut(draws.get("rpn"), rows)
        if rpn_draws is None:
            rpn_draws = uniform_draws(outputs["proposals"]["objectness"].shape, gen, rows=rows)
        stacked, metrics = compute_losses(outputs, batch, loss_cfg, noun_w, verb_w, rpn_draws,
                                          reduce)
        lw = torch.as_tensor(loss_w, dtype=torch.float32, device=dev)
        loss = (stacked * lw).sum() if loss_cfg.agg_mean else stacked.sum()
        loss.backward()
        # Parameters the loss does not reach (the frozen backbone behind the
        # tape cut) get zero gradients, as JAX's do.
        active = names if update_mult is None else [k for k in names if update_mult[k]]
        live = set(active) if world > 1 else set()
        grads = {k: grad_or_zeros(k, p, k in live) for k, p in params.items()}
        if world > 1:
            grads = sharding.reduce_grads(grads, active)
        grads = [grads[k] for k in names]
        mult = None if update_mult is None else [float(update_mult[k]) for k in names]
        if mult is not None:
            grads = torch._foreach_mul(grads, mult)
        updates, opt_state = tx.update(dict(zip(names, grads)), state.opt_state, opt_params)
        updates = [updates[k] for k in names]
        if mult is not None:
            updates = torch._foreach_mul(updates, mult)
        # Non-finite guard: a step whose loss or gradients are not finite
        # (on any rank) leaves parameters, optimizer state and running
        # averages as they were.
        max_abs = torch.stack(torch._foreach_norm(grads, float("inf")))
        bad = (~(torch.isfinite(loss) & torch.isfinite(max_abs).all())).float()
        metrics = _global_metrics({"loss": loss, **metrics, "nonfinite_skipped": bad})
        good = not bool(metrics["nonfinite_skipped"] > 0)
        if good:
            with torch.no_grad():
                torch._foreach_add_(opt_tensors, updates)
            if sharding.sharded:
                sharding.gather_()
            state.opt_state = opt_state
        elif before is not None:
            with torch.no_grad():
                for t, old in zip(stats.values(), before):
                    t.copy_(old)
        state.step += 1
        state.batch_stats = stats
        metrics["nonfinite_skipped"] = 0.0 if good else 1.0
        return {k: (v.detach() if isinstance(v, torch.Tensor) else v) for k, v in metrics.items()}

    return step_fn


def _freqs(noun_verb_frequencies, device):
    if noun_verb_frequencies is None:
        return None
    return torch.as_tensor(noun_verb_frequencies, dtype=torch.float32, device=device)


def make_eval_step(model, detector_cfg, noun_verb_frequencies=None):
    """Returns ``step_fn(batch) -> detections``: the eval forward and the
    postprocess, fixed-shape detections [B, K, ...] on the model's device,
    with the transformer TTC head's pass over them where the model has the
    head and the batch the hand history."""
    freqs = _freqs(noun_verb_frequencies, model.device)

    @torch.no_grad()
    def step_fn(batch):
        model.eval()
        outputs = model(batch)
        dets = detections_from_outputs(outputs, detector_cfg, noun_verb_frequencies=freqs)
        return _second_pass(model, dets, outputs, batch)

    return step_fn


def _second_pass(model, dets, outputs, batch):
    if model.tcfg.ttc_hand is None or "hand_boxes" not in batch:
        return dets
    return model.predict_ttc(dets, outputs["roi_outputs"], batch, batch["image_hw"])


def make_eval_loss_step(model, detector_cfg, loss_cfg: LossConfig, noun_w, verb_w,
                        noun_verb_frequencies=None):
    """Returns ``step_fn(batch, loss_w, draws=None) -> (detections, metrics)``
    from one trunk (``TransFusion.eval_with_losses``): the detections of
    every proposal, and the losses of the sampled branch with ``metrics
    ["loss"]`` the validation total over [bbox, noun, verb, ttc, lm] (the
    RPN slot is logged, not summed) under the normalised 5-slot ``loss_w``.
    The RoI and RPN samplers draw from generators seeded 0 and 1 on every
    call unless ``draws`` ({"roi", "rpn"}, as ``make_train_step``) are
    given. Under data parallelism the detections are the rank's and the
    losses the global batch's, as in the train step."""
    dev = model.device
    freqs = _freqs(noun_verb_frequencies, dev)
    noun_w, verb_w = torch.as_tensor(noun_w, device=dev), torch.as_tensor(verb_w, device=dev)

    @torch.no_grad()
    def step_fn(batch, loss_w, draws=None):
        model.eval()
        draws = draws or {}
        rows = batch_rows(batch["image"].shape[0])
        outputs = model.eval_with_losses(batch, _cut(draws.get("roi"), rows),
                                         torch.Generator(device=dev).manual_seed(0), rows)
        dets = detections_from_outputs(outputs["eval"], detector_cfg, noun_verb_frequencies=freqs)
        dets = _second_pass(model, dets, outputs["eval"], batch)
        if model.tcfg.ttc_hand is not None and "hand_boxes" in batch:
            # With the transformer head the per-RoI ttc is a placeholder: the
            # validation TTC loss scores the second pass's detections.
            k = min(model.tcfg.max_ttc_boxes, dets["ttcs"].shape[1])
            outputs["loss"]["ttc_hand"] = {"ttcs": dets["ttcs"][:, :k], "valid": dets["valid"][:, :k]}
        rpn_draws = _cut(draws.get("rpn"), rows)
        if rpn_draws is None:
            rpn_draws = uniform_draws(outputs["loss"]["proposals"]["objectness"].shape,
                                      torch.Generator(device=dev).manual_seed(1), rows=rows)
        stacked, metrics = compute_losses(outputs["loss"], batch, loss_cfg, noun_w, verb_w,
                                          rpn_draws, global_sum if world_size() > 1 else None)
        val = stacked[torch.tensor([0, 2, 3, 4, 5], device=dev)]
        lw = torch.as_tensor(loss_w, dtype=torch.float32, device=dev)
        total = (val * lw).sum() if loss_cfg.agg_mean else val.sum()
        return dets, _global_metrics({"loss": total, **metrics})

    return step_fn
