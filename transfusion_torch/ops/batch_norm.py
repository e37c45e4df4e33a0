"""Trainable BatchNorm with flax's numerics, its statistics synchronised
over the data axis (the ``model.batch_norm.use`` path of
``transfusion_tpu/models/resnet.py:50-110``: ``nn.BatchNorm`` after every
conv of the trunk).

flax's ``BatchNorm(dtype=compute dtype)`` and its autodiff, as JAX runs
them under a data-sharded ``jit``:
  * statistics in f32 (at least: x's dtype promoted with f32) over the
    global batch: mean = E[x], var = max(0, E[x^2] - E[x]^2) (the fast
    variance, clipped);
  * y = ((x - mean) * (rsqrt(var + eps) * scale) + bias) in that precision,
    returned in the compute dtype;
  * the running averages keep the biased variance:
    new = m * old + (1 - m) * batch with flax's m = 1 - the config's
    momentum;
  * eval (``use_running_average``) normalises with the running averages.

:class:`BatchNormFunction` is the training forward and its backward. With
more than one rank in the process group the forward all-reduces the
per-channel sums of x and x^2 (and the count) and the backward the two
per-channel gradient sums, so every rank normalises and differentiates
with the global batch's statistics, as XLA's reductions over the sharded
batch do; the scale and bias gradients stay the rank's own sums, which the
train step's gradient reduction adds up. ``torch.nn.SyncBatchNorm`` is not
used: it refuses CPU tensors, where the gloo tests run. The gradient of x
is formed as JAX's autodiff forms it: the direct term and the statistics'
term, each rounded to x's dtype, then added.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from transfusion_torch.parallel.mesh import world_size

_DIMS = (0, 2, 3)


def _shape(v):
    return v[None, :, None, None]


def _wide(x):
    """x in its statistics' precision: f32, or wider if x is."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def batch_moments(x, sync: bool):
    """(mean, E[x^2] - mean^2 before the clip, count) per channel of
    [N, C, H, W] ``x`` in f32 (or x's wider dtype), over every rank's rows
    when ``sync``."""
    xf = _wide(x)
    c = x.shape[1]
    stats = torch.cat([xf.sum(_DIMS), (xf * xf).sum(_DIMS),
                       torch.full((1,), float(x.numel() // c), dtype=xf.dtype, device=x.device)])
    if sync:
        dist.all_reduce(stats)
    count = stats[-1]
    mean = stats[:c] / count
    return mean, stats[c:2 * c] / count - mean * mean, count


def normalize(x, mean, var, weight, bias, eps: float):
    """flax's ``_normalize``: f32 (or wider) arithmetic, output in x's dtype."""
    mul = torch.rsqrt(_shape(var) + eps) * _shape(weight)
    return ((_wide(x) - _shape(mean)) * mul + _shape(bias)).to(x.dtype)


class BatchNormFunction(torch.autograd.Function):
    """Training-mode BatchNorm of [N, C, H, W] ``x`` given its (global)
    ``mean``, unclipped ``var_raw`` and ``count`` from :func:`batch_moments`."""

    @staticmethod
    def forward(ctx, x, weight, bias, mean, var_raw, count, eps: float, sync: bool):
        var = torch.clamp(var_raw, min=0.0)
        ctx.save_for_backward(x, weight, mean, var, count, var_raw > 0)
        ctx.eps, ctx.sync = eps, sync
        return normalize(x, mean, var, weight, bias, eps)

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, var, count, var_live = ctx.saved_tensors
        xf = _wide(x)
        dyf = dy.to(xf.dtype)
        inv = torch.rsqrt(var + ctx.eps)
        xc = xf - _shape(mean)
        local = torch.cat([dyf.sum(_DIMS), (dyf * xc).sum(_DIMS)])
        sums = local.clone()
        if ctx.sync:
            dist.all_reduce(sums)
        c = x.shape[1]
        sum_dy, sum_dy_xc = sums[:c], sums[c:]
        mul = inv * weight
        # y = (x - mean) * mul + bias, mean = E[x], var = max(0, E[x^2] - mean^2).
        d_var = torch.where(var_live, sum_dy_xc * weight * (-0.5) * inv ** 3, 0.0)
        d_mean = -sum_dy * mul - 2.0 * mean * d_var
        direct = dyf * _shape(mul)
        stats = _shape(d_mean / count) + xf * _shape(2.0 * d_var / count)
        dx = direct.to(x.dtype) + stats.to(x.dtype)
        d_weight = (local[c:] * inv).to(weight.dtype)
        return dx, d_weight, local[:c].to(weight.dtype), None, None, None, None, None


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=1 - momentum, epsilon=eps)`` over the
    channels of [N, C, H, W]: trainable ``weight`` (flax ``scale``) and
    ``bias``, running averages in the ``running_mean`` / ``running_var``
    buffers (flax ``batch_stats`` ``mean`` / ``var``), the reference
    torch names. ``forward(x, train)``: batch statistics (synchronised
    over the ranks) and a running-average update when ``train``, the
    running averages otherwise; the update runs also where no gradient is
    recorded (a stage the freeze schedule cuts from the tape), as flax's
    ``batch_stats`` update ignores ``stop_gradient``."""

    def __init__(self, c: int, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.decay = 1.0 - momentum  # flax's momentum
        self.eps = eps

    def forward(self, x, train: bool = False):
        if not train:
            return normalize(x, self.running_mean, self.running_var, self.weight, self.bias,
                             self.eps)
        sync = world_size() > 1
        with torch.no_grad():
            mean, var_raw, count = batch_moments(x, sync)
            m = self.decay
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1 - m) * torch.clamp(var_raw, min=0.0))
        return BatchNormFunction.apply(x, self.weight, self.bias, mean, var_raw, count, self.eps,
                                       sync)


def batch_norm_plain(x, weight, bias, eps: float = 1e-5):
    """Training-mode BatchNorm of one rank's ``x`` by autograd through the
    formula (the reference for :class:`BatchNormFunction` in one process):
    (output, mean, biased variance)."""
    xf = _wide(x)
    mean = xf.mean(_DIMS)
    var = torch.clamp((xf * xf).mean(_DIMS) - mean * mean, min=0.0)
    return normalize(x, mean, var, weight, bias, eps), mean, var
