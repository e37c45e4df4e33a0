"""(Residual-add +) LayerNorm over the last dim: kernel K1 and its plain
version.

Port of ``transfusion_tpu/ops/layer_norm.py`` (Pallas ``_ln_kernel`` and
``_res_ln_kernel``): statistics in f32 with var = max(E[x^2] - mean^2, 0),
eps 1e-6 by default, f32 affine, output in the input dtype. The residual form
LN(x + r) rounds the sum to the input dtype before the statistics, as the TPU
kernel does.

On a CUDA tensor :func:`fused_layer_norm` launches ``csrc/layer_norm.cu``;
on a CPU tensor it runs :func:`layer_norm_plain`. The kernel has no
backward, as the TPU kernel runs on eval passes only (layer_norm.py:175-192):
it refuses a CUDA input that requires grad while grad mode is on, and
:class:`FusedLayerNorm` in training mode takes the differentiable plain
version, which is the LayerNorm the JAX package trains with (flax's, with
the same variance formula).
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


def _layer_norm_cuda(x, weight, bias, eps, residual):
    d = x.shape[-1]
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, residual, weight, bias)):
        raise RuntimeError("fused_layer_norm: the LayerNorm kernel has no backward; train with "
                           "layer_norm_plain (FusedLayerNorm does in training mode)")
    kernels.require(x.dtype in (torch.float32, torch.bfloat16), f"layer_norm: dtype {x.dtype}")
    kernels.require(x.is_contiguous(), "layer_norm: x must be contiguous")
    kernels.require(d % 8 == 0 and d <= 1024, "layer_norm: the last dim must be a multiple of 8, <= 1024")
    kernels.require(x.data_ptr() % 16 == 0, "layer_norm: x must be 16-byte aligned")
    kernels.require(weight.shape == (d,) and bias.shape == (d,), "layer_norm: affine shape")
    kernels.require(weight.dtype == torch.float32 and bias.dtype == torch.float32,
                    "layer_norm: affine params must be float32")
    kernels.require(weight.device == x.device and bias.device == x.device, "layer_norm: devices differ")
    if residual is not None:
        kernels.require(residual.shape == x.shape and residual.dtype == x.dtype
                        and residual.is_contiguous() and residual.device == x.device
                        and residual.data_ptr() % 16 == 0,
                        "layer_norm: residual must match x")
    w, b = weight.contiguous(), bias.contiguous()
    out = torch.empty_like(x)
    rows = x.numel() // d
    lib = kernels.library()
    code = lib.tf_layer_norm(
        x.data_ptr(), None if residual is None else residual.data_ptr(),
        w.data_ptr(), b.data_ptr(), out.data_ptr(), rows, d, float(eps),
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


class FusedLayerNorm(nn.Module):
    """Same parameter names as ``nn.LayerNorm`` (``weight``/``bias``);
    ``forward(x, residual=h)`` fuses the post-norm residual add. Inputs are
    cast to ``dtype`` first, as the JAX module does. In training mode it
    runs the plain, differentiable version; in eval mode the kernel."""

    def __init__(self, dim: int, eps: float = 1e-6, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps
        self.dtype = dtype

    def forward(self, x, residual=None):
        x = x.to(self.dtype).contiguous()
        if residual is not None:
            residual = residual.to(self.dtype).contiguous()
        if self.training:
            return layer_norm_plain(x, self.weight, self.bias, self.eps, residual)
        return fused_layer_norm(x, self.weight, self.bias, self.eps, residual)
