"""Optimizer and learning-rate schedule (port of
``transfusion_tpu/train/optim.py``): the epoch schedules (exponential,
multistep, gradual warmup into either) and the RAdam chain of the reference
configs, with the per-group learning-rate factors.

The update is written as the optax chain computes it, in float32:
  [clip_by_global_norm] -> scale_by_radam -> add_decayed_weights
  -> [scale_by_label] -> scale_by_learning_rate.
It differs from ``torch.optim.RAdam`` and ``clip_grad_norm_``: optax adds
eps to the square root of the bias-corrected second moment and rectifies
once rho >= 5; it clips by ``g * max / norm`` only when the norm is at
least ``max``; the decoupled weight decay is added after RAdam, then scaled
by the group factor and the learning rate. One step count serves every
parameter, as in optax.

Parameters, gradients and moments are dictionaries keyed by the port's
parameter names. The optimizer is functional like optax's:
``tx.init(params)`` gives the state ``{"count", "mu", "nu"}`` and
``tx.update(grads, state, params)`` returns (updates, new state), to be
added to the parameters.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def make_epoch_schedule(scheduler_cfg: dict | None, base_lr: float,
                        steps_per_epoch: int) -> Callable[[int], float]:
    """Learning rate (float32) as a function of the global step, constant
    within an epoch."""
    f32 = np.float32
    if not scheduler_cfg or not scheduler_cfg.get("use", False):
        return lambda step: f32(base_lr)
    name = scheduler_cfg["name"]
    gamma = f32(scheduler_cfg.get("gamma", 0.1))
    milestones = list(scheduler_cfg.get("milestones", []))

    def passed(epoch):
        return f32(sum(f32(epoch >= m) for m in milestones)) if milestones else f32(0.0)

    if name == "exponential":
        def epoch_fn(epoch):
            return f32(base_lr) * gamma ** epoch
    elif name == "multistep":
        def epoch_fn(epoch):
            return f32(base_lr) * gamma ** passed(epoch)
    elif name == "warmup":
        multiplier = f32(scheduler_cfg.get("multiplier", 1.0))
        total_epoch = f32(scheduler_cfg.get("total_epoch", 1))
        after = scheduler_cfg.get("after_warmup")

        def after_fn(epoch):
            if after == "exponential":
                return f32(base_lr) * multiplier * gamma ** epoch
            if after == "multistep":
                return f32(base_lr) * multiplier * gamma ** passed(epoch)
            return f32(base_lr) * multiplier

        def epoch_fn(epoch):
            # GradualWarmupScheduler: lr = base * ((mult - 1) * e / total + 1)
            if epoch < total_epoch:
                return f32(base_lr) * ((multiplier - f32(1)) * min(epoch, total_epoch) / total_epoch
                                       + f32(1))
            return after_fn(max(epoch - total_epoch, f32(0)))
    else:
        raise ValueError(f"unknown scheduler {name}")
    return lambda step: f32(epoch_fn(f32(step) // f32(max(steps_per_epoch, 1))))


def param_group_label(name: str) -> str:
    """The JAX package's LR groups (optim.py:87-97) under the port's names:
    the ResNet body (JAX ``backbone``; the FPN is ``backbone.fpn`` here and
    ``rcnn/fpn`` there, so not in it) and the narration encoder are
    'encoder', the TTC head 'ttc', everything else 'main'."""
    if name.startswith(("backbone.body.", "narr_pooling_layer.")):
        return "encoder"
    if "ttc_pred_layer" in name:
        return "ttc"
    return "main"


class RAdamChain:
    """The optax chain above for ``optax.scale_by_radam()`` defaults (b1 0.9,
    b2 0.999, eps 1e-8, eps_root 0, threshold 5)."""

    b1, b2, eps, threshold = 0.9, 0.999, 1e-8, 5.0

    def __init__(self, schedule: Callable[[int], float], weight_decay: float = 0.0,
                 grad_clip: float | None = None, scales: dict | None = None):
        self.schedule, self.weight_decay, self.grad_clip = schedule, weight_decay, grad_clip
        self.scales = scales or {}

    def init(self, params: dict) -> dict:
        zeros = {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}
        return {"count": 0, "mu": zeros, "nu": {k: torch.zeros_like(z) for k, z in zeros.items()}}

    def update(self, grads: dict, state: dict, params: dict):
        names = list(params)
        g = [grads[k].float() for k in names]
        if self.grad_clip:
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g)))
            # select(norm < max, g, g / norm * max), without a host sync.
            keep = norm < self.grad_clip
            clipped = torch._foreach_div(g, norm)
            torch._foreach_mul_(clipped, self.grad_clip)
            g = [torch.where(keep, a, b) for a, b in zip(g, clipped)]
        mu_old = [state["mu"][k] for k in names]
        nu_old = [state["nu"][k] for k in names]
        # mu = (1 - b1) g + b1 mu; nu = (1 - b2) g^2 + b2 nu.
        mu = torch._foreach_mul(g, 1.0 - self.b1)
        torch._foreach_add_(mu, torch._foreach_mul(mu_old, self.b1))
        nu = torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - self.b2)
        torch._foreach_add_(nu, torch._foreach_mul(nu_old, self.b2))
        count = state["count"] + 1
        # The rectification scalars in float32 as optax computes them: rho
        # comes from a difference of large numbers, and its float32 value
        # decides both the branch and the factor r.
        f32 = np.float32
        b1t, b2t = f32(self.b1) ** f32(count), f32(self.b2) ** f32(count)
        ro_inf = 2.0 / (1.0 - self.b2) - 1.0  # a Python float there too
        ro = f32(ro_inf) - f32(2 * count) * b2t / (f32(1) - b2t)
        mu_hat = torch._foreach_div(mu, float(f32(1) - b1t))
        if ro >= self.threshold:
            r = np.sqrt((ro - f32(4)) * (ro - f32(2)) * f32(ro_inf)
                        / (f32((ro_inf - 4.0) * (ro_inf - 2.0)) * ro))
            nu_hat = torch._foreach_div(nu, float(f32(1) - b2t))
            denom = torch._foreach_sqrt(nu_hat)
            torch._foreach_add_(denom, self.eps)
            upd = torch._foreach_mul(mu_hat, float(f32(r)))
            torch._foreach_div_(upd, denom)
        else:
            upd = mu_hat
        upd = list(upd)
        if self.weight_decay:
            torch._foreach_add_(upd, torch._foreach_mul([params[k].float() for k in names],
                                                        self.weight_decay))
        for i, k in enumerate(names):
            s = self.scales.get(param_group_label(k), 1.0)
            if s != 1.0:
                upd[i] = upd[i] * s
        torch._foreach_mul_(upd, float(-self.schedule(state["count"])))
        return (dict(zip(names, upd)),
                {"count": count, "mu": dict(zip(names, mu)), "nu": dict(zip(names, nu))})


def make_optimizer(optimizer_cfg: dict, scheduler_cfg: dict | None, steps_per_epoch: int,
                   grad_clip: float | None = None):
    """(optimizer, schedule) for a reference run config: ``radam`` with
    weight decay, global-norm clipping and the ``sep_encoders`` LR groups."""
    name = optimizer_cfg.get("name", "radam")
    if name != "radam":
        raise NotImplementedError(f"optimizer {name!r} is not ported yet (radam is)")
    schedule = make_epoch_schedule(scheduler_cfg, optimizer_cfg.get("lr", 1e-4), steps_per_epoch)
    sep = optimizer_cfg.get("sep_encoders") or {}
    scales = {}
    if sep.get("div_rate"):
        scales["encoder"] = 1.0 / sep["div_rate"]
    if sep.get("ttc_rate"):
        scales["ttc"] = 1.0 / sep["ttc_rate"]
    tx = RAdamChain(schedule, optimizer_cfg.get("weight_decay", 0.0), grad_clip, scales)
    return tx, schedule
