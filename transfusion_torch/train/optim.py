"""Optimizer and learning-rate schedule (port of
``transfusion_tpu/train/optim.py``): the epoch schedules (exponential,
multistep, gradual warmup into either), the optimizers of the reference
configs (radam, adam, adamw, sgd, rmsprop) with the per-group learning-rate
factors, gradient accumulation and a freeze mask.

Each update is written as the optax chain computes it, in float32:
  [clip_by_global_norm] -> core -> [scale_by_label] -> scale_by_learning_rate
with the core
  radam:   scale_by_radam -> [add_decayed_weights]
  adam:    scale_by_adam -> [add_decayed_weights]
  adamw:   scale_by_adam -> add_decayed_weights
  sgd:     [add_decayed_weights] -> trace(momentum)
  rmsprop: scale_by_rms -> [add_decayed_weights] -> trace(momentum)
(decay only when the weight decay is non-zero). It differs from
``torch.optim``: optax adds eps to the square root of the bias-corrected
second moment (RMSProp: inside it) and rectifies RAdam once rho >= 5; it
clips by ``g * max / norm`` only when the norm is at least ``max``; the
decoupled weight decay is added after the moments, then scaled by the group
factor and the learning rate. One step count serves every parameter, as in
optax. :class:`MultiSteps` is ``optax.MultiSteps`` (the running mean of k
gradients, one inner update every k calls, zeros between); a freeze mask is
``optax.multi_transform`` with ``set_to_zero`` for the frozen names (the
chain, clipping included, sees only the trained ones).

Parameters, gradients and moments are dictionaries keyed by the port's
parameter names. The optimizer is functional like optax's:
``tx.init(params)`` gives the state (``{"count", "mu", "nu"}`` for RAdam)
and ``tx.update(grads, state, params)`` returns (updates, new state), to be
added to the parameters. Under fully-sharded data parallelism the tensors
are a rank's shards (``parallel.fsdp.Sharding.views``) and
:func:`attach_sharding` makes clipping's global norm add the shards'
squares over the ranks.
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


class Chain:
    """The optax chain above for ``name`` at optax's defaults (b1 0.9, b2
    0.999, eps 1e-8, eps_root 0, RAdam threshold 5; RMS decay 0.9, eps 1e-8,
    initial scale 0)."""

    b1, b2, eps, threshold, rms_decay = 0.9, 0.999, 1e-8, 5.0, 0.9
    NAMES = ("radam", "adam", "adamw", "sgd", "rmsprop")

    def __init__(self, schedule: Callable[[int], float], weight_decay: float = 0.0,
                 grad_clip: float | None = None, scales: dict | None = None,
                 name: str = "radam", momentum: float = 0.9):
        if name not in self.NAMES:
            raise ValueError(f"unknown optimizer {name}")
        self.schedule, self.weight_decay, self.grad_clip = schedule, weight_decay, grad_clip
        self.scales, self.name, self.momentum = scales or {}, name, momentum
        self.sharding = None  # parallel.fsdp.Sharding of sharded tensors, if any

    def init(self, params: dict) -> dict:
        def zeros():
            return {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}

        keys = {"radam": ("mu", "nu"), "adam": ("mu", "nu"), "adamw": ("mu", "nu"),
                "sgd": ("trace",), "rmsprop": ("nu", "trace")}[self.name]
        return {"count": 0, **{k: zeros() for k in keys}}

    def _clip(self, g, names):
        norms = torch._foreach_norm(g)
        if self.sharding is None:
            norm = torch.linalg.vector_norm(torch.stack(norms))
        else:
            norm = torch.sqrt(self.sharding.sq_norm(names, norms))
        # select(norm < max, g, g / norm * max), without a host sync.
        keep = norm < self.grad_clip
        clipped = torch._foreach_div(g, norm)
        torch._foreach_mul_(clipped, self.grad_clip)
        return [torch.where(keep, a, b) for a, b in zip(g, clipped)]

    @staticmethod
    def _ema(new, old, decay: float, square: bool = False):
        """(1 - decay) * new(^2) + decay * old, as optax's moment updates."""
        out = torch._foreach_mul(torch._foreach_mul(new, new) if square else new, 1.0 - decay)
        torch._foreach_add_(out, torch._foreach_mul(old, decay))
        return out

    def _decay(self, upd, params, names):
        if self.weight_decay or self.name == "adamw":
            torch._foreach_add_(upd, torch._foreach_mul([params[k].float() for k in names],
                                                        self.weight_decay))

    def _trace(self, upd, old):
        """optax.trace: t = u + momentum * t_prev; the update is t."""
        out = torch._foreach_mul(old, self.momentum)
        torch._foreach_add_(out, upd)
        return out

    def _adam(self, g, state, names, count, rectify: bool):
        mu = self._ema(g, [state["mu"][k] for k in names], self.b1)
        nu = self._ema(g, [state["nu"][k] for k in names], self.b2, square=True)
        # The bias corrections and RAdam's rectification in float32 as optax
        # computes them: rho comes from a difference of large numbers, and
        # its float32 value decides both the branch and the factor r.
        f32 = np.float32
        b1t, b2t = f32(self.b1) ** f32(count), f32(self.b2) ** f32(count)
        mu_hat = torch._foreach_div(mu, float(f32(1) - b1t))
        r = None
        if rectify:
            ro_inf = 2.0 / (1.0 - self.b2) - 1.0  # a Python float there too
            ro = f32(ro_inf) - f32(2 * count) * b2t / (f32(1) - b2t)
            if ro >= self.threshold:
                r = np.sqrt((ro - f32(4)) * (ro - f32(2)) * f32(ro_inf)
                            / (f32((ro_inf - 4.0) * (ro_inf - 2.0)) * ro))
        if rectify and r is None:
            upd = list(mu_hat)
        else:
            nu_hat = torch._foreach_div(nu, float(f32(1) - b2t))
            denom = torch._foreach_sqrt(nu_hat)
            torch._foreach_add_(denom, self.eps)
            upd = torch._foreach_mul(mu_hat, float(f32(r))) if r is not None else mu_hat
            upd = list(torch._foreach_div(upd, denom))
        return upd, {"mu": dict(zip(names, mu)), "nu": dict(zip(names, nu))}

    def update(self, grads: dict, state: dict, params: dict):
        names = list(params)
        g = [grads[k].float() for k in names]
        if self.grad_clip:
            g = self._clip(g, names)
        count = state["count"] + 1
        new = {"count": count}
        if self.name in ("radam", "adam", "adamw"):
            upd, moments = self._adam(g, state, names, count, rectify=self.name == "radam")
            new.update(moments)
            self._decay(upd, params, names)
        elif self.name == "sgd":
            upd = list(g)
            if self.weight_decay:
                upd = [u.clone() for u in upd]
            self._decay(upd, params, names)
            upd = self._trace(upd, [state["trace"][k] for k in names])
            new["trace"] = dict(zip(names, upd))
        else:  # rmsprop
            nu = self._ema(g, [state["nu"][k] for k in names], self.rms_decay, square=True)
            upd = torch._foreach_mul(g, torch._foreach_rsqrt(torch._foreach_add(nu, self.eps)))
            self._decay(upd, params, names)
            upd = self._trace(upd, [state["trace"][k] for k in names])
            new.update(nu=dict(zip(names, nu)), trace=dict(zip(names, upd)))
        upd = list(upd)
        for i, k in enumerate(names):
            s = self.scales.get(param_group_label(k), 1.0)
            if s != 1.0:
                upd[i] = upd[i] * s
        upd = torch._foreach_mul(upd, float(-self.schedule(state["count"])))
        return dict(zip(names, upd)), new


class MultiSteps:
    """``optax.MultiSteps(tx, every_k_schedule=k)``: gradients accumulate as
    a running mean; every k-th call applies ``tx`` to it and resets it, the
    calls between return zero updates and keep ``tx``'s state."""

    def __init__(self, inner, every_k: int):
        self.inner, self.k = inner, int(every_k)

    def init(self, params: dict) -> dict:
        return {"mini_step": 0, "gradient_step": 0, "inner": self.inner.init(params),
                "acc": {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}}

    def update(self, grads: dict, state: dict, params: dict):
        n = state["mini_step"]
        acc = {k: a + (grads[k].float() - a) / (n + 1) for k, a in state["acc"].items()}
        if n == self.k - 1:
            upd, inner = self.inner.update(acc, state["inner"], params)
            return upd, {"mini_step": 0, "gradient_step": state["gradient_step"] + 1,
                         "inner": inner, "acc": {k: torch.zeros_like(a) for k, a in acc.items()}}
        return ({k: torch.zeros_like(a) for k, a in acc.items()},
                {**state, "mini_step": n + 1, "acc": acc})


class FreezeMask:
    """``optax.multi_transform({"train": tx, "frozen": set_to_zero()},
    labels)`` over {name: "train" | "frozen"}: ``tx`` (and its clipping) sees
    the trained names only, the frozen ones get zero updates and no state."""

    def __init__(self, inner, labels: dict):
        self.inner, self.labels = inner, labels

    def _train(self, tree: dict) -> dict:
        return {k: v for k, v in tree.items() if self.labels[k] == "train"}

    def init(self, params: dict) -> dict:
        return self.inner.init(self._train(params))

    def update(self, grads: dict, state: dict, params: dict):
        upd, state = self.inner.update(self._train(grads), state, self._train(params))
        return {k: upd[k] if k in upd else torch.zeros_like(p, dtype=torch.float32)
                for k, p in params.items()}, state


def attach_sharding(tx, sharding) -> None:
    """Tell ``tx``'s chain (inside its wrappers) which of its tensors are
    shards, for clipping's global norm; no-op when none is."""
    while hasattr(tx, "inner"):
        tx = tx.inner
    tx.sharding = sharding if sharding is not None and sharding.sharded else None


def make_optimizer(optimizer_cfg: dict, scheduler_cfg: dict | None, steps_per_epoch: int,
                   grad_clip: float | None = None, accumulate: int = 1,
                   freeze_mask: dict | None = None):
    """(optimizer, schedule) for a reference run config: ``name`` one of
    radam, adam, adamw, sgd, rmsprop, with weight decay, global-norm
    clipping, the ``sep_encoders`` LR groups, ``accumulate`` gradients a
    step (:class:`MultiSteps`) and an optional {name: "train" | "frozen"}
    ``freeze_mask``."""
    schedule = make_epoch_schedule(scheduler_cfg, optimizer_cfg.get("lr", 1e-4), steps_per_epoch)
    sep = optimizer_cfg.get("sep_encoders") or {}
    scales = {}
    if sep.get("div_rate"):
        scales["encoder"] = 1.0 / sep["div_rate"]
    if sep.get("ttc_rate"):
        scales["ttc"] = 1.0 / sep["ttc_rate"]
    tx = Chain(schedule, optimizer_cfg.get("weight_decay", 0.0), grad_clip, scales,
               optimizer_cfg.get("name", "radam"), optimizer_cfg.get("momentum", 0.9))
    if freeze_mask is not None:
        tx = FreezeMask(tx, freeze_mask)
    if accumulate > 1:
        tx = MultiSteps(tx, accumulate)
    return tx, schedule
