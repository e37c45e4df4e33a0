"""(Residual-add +) LayerNorm over the last dim: kernel K1 and its plain
version.

Port of ``transfusion_tpu/ops/layer_norm.py`` (Pallas ``_ln_kernel`` and
``_res_ln_kernel``): statistics in f32 with var = max(E[x^2] - mean^2, 0),
eps 1e-6 by default, f32 affine, output in the input dtype. The residual form
LN(x + r) rounds the sum to the input dtype before the statistics, as the TPU
kernel does.

On a CUDA tensor :func:`fused_layer_norm` launches ``csrc/layer_norm.cu``
at any width from 1 to 1024 (16-byte designs where the width is a multiple
of 8 and the pointers allow it, else a warp a row with 8-byte or scalar
loads), which reads ``x`` in place when its rows are contiguous within each
batch (:func:`row_layout`: a contiguous tensor, or a view such as
``x[:, :n]``);
on a CPU tensor it runs :func:`layer_norm_plain`. The kernel has no
backward, so it refuses a CUDA input that requires grad while grad mode is
on. :func:`layer_norm` is the differentiable form, JAX's ``custom_vjp``
(``_fused_ln`` / ``_fused_res_ln``): K1 forward, and a closed-form backward
in PyTorch from the saved input with recomputed f32 statistics
(:func:`_ln_grads`). :class:`FusedLayerNorm`, :class:`FlaxLayerNorm` and the
narration encoder's norms run it in training and in eval alike. (The JAX
module trains with flax's LayerNorm, whose variance formula is the same.)
"""

from __future__ import annotations

import torch
from torch import nn

from transfusion_torch import kernels


def layer_norm_plain(x, weight, bias, eps: float = 1e-6, residual=None):
    """Plain PyTorch statement of the kernel's arithmetic."""
    s = x if residual is None else x + residual
    sf = s.float()
    mean = sf.mean(-1, keepdim=True)
    var = torch.clamp((sf * sf).mean(-1, keepdim=True) - mean * mean, min=0.0)
    y = (sf - mean) * torch.rsqrt(var + eps) * weight.float() + bias.float()
    return y.to(x.dtype)


def row_layout(x):
    """(rows per batch, batch stride in elements) with which the kernel reads
    ``x`` in place, or None. A contiguous ``x`` is one batch of all its rows;
    otherwise the last two dims must hold contiguous rows ([..., n, d] with
    strides (..., d, 1)) and the dims before them must merge into one batch
    dim, as in ``x[:, :n]`` of a contiguous [B, N, d]."""
    d = x.shape[-1]
    if x.is_contiguous():
        return x.numel() // d, 0
    if x.dim() < 3 or x.stride(-1) != 1 or x.stride(-2) != d:
        return None
    lead = [(n, st) for n, st in zip(x.shape[:-2], x.stride()[:-2]) if n != 1]
    for (_, st), (n_in, st_in) in zip(lead, lead[1:]):
        if st != st_in * n_in:
            return None
    return x.shape[-2], lead[-1][1] if lead else 0


def _layer_norm_cuda(x, weight, bias, eps, residual):
    d = x.shape[-1]
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, residual, weight, bias)):
        raise RuntimeError("fused_layer_norm: the LayerNorm kernel has no backward; train through "
                           "layer_norm (FusedLayerNorm does)")
    kernels.require(x.dtype in (torch.float32, torch.bfloat16), f"layer_norm: dtype {x.dtype}")
    kernels.require(0 < d <= 1024, "layer_norm: the last dim must be 1 to 1024")
    layout = row_layout(x)
    kernels.require(layout is not None, "layer_norm: x must hold contiguous rows within each batch")
    rows_per_batch, batch_stride = layout
    kernels.require(weight.shape == (d,) and bias.shape == (d,), "layer_norm: affine shape")
    kernels.require(weight.dtype == torch.float32 and bias.dtype == torch.float32,
                    "layer_norm: affine params must be float32")
    kernels.require(weight.device == x.device and bias.device == x.device, "layer_norm: devices differ")
    if residual is not None:
        kernels.require(residual.shape == x.shape and residual.dtype == x.dtype
                        and residual.is_contiguous() and residual.device == x.device,
                        "layer_norm: residual must match x and be contiguous")
    w, b = weight.contiguous(), bias.contiguous()
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    rows = x.numel() // d
    code = kernels.library().tf_layer_norm(
        x.data_ptr(), None if residual is None else residual.data_ptr(),
        w.data_ptr(), b.data_ptr(), out.data_ptr(), rows, d, rows_per_batch, batch_stride, float(eps),
        int(x.dtype == torch.bfloat16), kernels.stream_handle(x.device),
    )
    kernels.check(code, "tf_layer_norm")
    kernels.LAUNCHES["layer_norm" if residual is None else "residual_layer_norm"] += 1
    return out


def fused_layer_norm(x, weight, bias, eps: float = 1e-6, residual=None):
    """LayerNorm over the last dim of ``x`` (or of ``x + residual``)."""
    if x.device.type == "cpu":
        return layer_norm_plain(x, weight, bias, eps, residual)
    return _layer_norm_cuda(x, weight, bias, eps, residual)


def _ln_grads(s, weight, g, eps):
    """Closed-form LayerNorm gradient of ``s`` (the sum, in its dtype) with
    recomputed f32 statistics: (dx in f32, dweight, dbias)."""
    sf, gf = s.float(), g.float()
    mean = sf.mean(-1, keepdim=True)
    var = torch.clamp((sf * sf).mean(-1, keepdim=True) - mean * mean, min=0.0)
    rstd = torch.rsqrt(var + eps)
    xhat = (sf - mean) * rstd
    gw = gf * weight.float()
    gx = rstd * (gw - gw.mean(-1, keepdim=True) - xhat * (gw * xhat).mean(-1, keepdim=True))
    d = g.shape[-1]
    return (gx, (gf * xhat).reshape(-1, d).sum(0).to(weight.dtype),
            gf.reshape(-1, d).sum(0).to(weight.dtype))


class _LayerNormFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, eps, residual):
        ctx.save_for_backward(x, weight, residual)
        ctx.eps = eps
        return fused_layer_norm(x, weight, bias, eps, residual)

    @staticmethod
    def backward(ctx, g):
        x, weight, residual = ctx.saved_tensors
        gx, gw, gb = _ln_grads(x if residual is None else x + residual, weight, g, ctx.eps)
        gx = gx.to(x.dtype)
        return gx, gw, gb, None, None if residual is None else gx


def layer_norm(x, weight, bias, eps: float = 1e-6, residual=None):
    """:func:`fused_layer_norm` with a backward: K1 forward on the card (its
    plain version on the CPU), the gradient from :func:`_ln_grads`."""
    return _LayerNormFn.apply(x, weight, bias, eps, residual)


class FusedLayerNorm(nn.Module):
    """Same parameter names as ``nn.LayerNorm`` (``weight``/``bias``);
    ``forward(x, residual=h)`` fuses the post-norm residual add. Inputs are
    cast to ``dtype`` first, as the JAX module does. It runs
    :func:`layer_norm`: the kernel forward in training and eval."""

    def __init__(self, dim: int, eps: float = 1e-6, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps
        self.dtype = dtype

    def forward(self, x, residual=None):
        x = x.to(self.dtype)
        if row_layout(x) is None:
            x = x.contiguous()  # the kernel reads batch-strided views such as x[:, :n] in place
        if residual is not None:
            residual = residual.to(self.dtype).contiguous()
        return layer_norm(x, self.weight, self.bias, self.eps, residual)


class FlaxLayerNorm(FusedLayerNorm):
    """flax ``nn.LayerNorm(dtype=dtype)``, where the JAX model uses it rather
    than its fused module: ``x`` (or ``x + residual``, both in their promoted
    dtype, as JAX adds them) is normalised in its own dtype, with f32
    statistics, and only the output is rounded to ``dtype``. An f32 stream
    (bf16 tokens plus an f32 embedding) runs K1 in f32."""

    def forward(self, x, residual=None):
        if residual is not None:
            dt = torch.promote_types(x.dtype, residual.dtype)
            x, residual = x.to(dt), residual.to(dt).contiguous()
        if row_layout(x) is None:
            x = x.contiguous()
        return layer_norm(x, self.weight, self.bias, self.eps, residual).to(self.dtype)
