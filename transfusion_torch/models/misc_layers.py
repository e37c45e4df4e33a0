"""Upsample and heatmap-conditioning layers of the legacy heatmap family
(port of ``transfusion_tpu/models/misc_layers.py``).

Feature maps are NCHW (the port's conv layout); ``size`` is (H, W). The
resizes follow JAX's conventions, not ``F.interpolate``'s defaults:

* bilinear samples input row ``i * (in - 1) / (out - 1)`` (torch's
  ``align_corners=True``), written out with gathers as the JAX module is;
* bicubic is ``jax.image.resize(..., "cubic")``: the Keys kernel with
  a = -0.5 on half-pixel centres, each output's weights renormalised to sum
  to 1 at the edges, the kernel stretched by the scale when shrinking
  (antialiasing). Torch's bicubic uses a = -0.75 and clamps the indices, so
  the weights are built here and applied as two matrix products;
* nearest is ``jax.image.resize(..., "nearest")``: output ``o`` reads input
  ``floor((o + 0.5) * in / out)`` (torch's ``nearest-exact``), computed in
  f32 as JAX does.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from transfusion_torch.models.resnet import conv


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def cubic_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_in, n_out] f32 weights of ``jax.image.resize``'s cubic resize of
    one axis (``compute_weight_mat`` with antialiasing and no translation)."""
    f32 = np.float32
    inv_scale = f32(1.0) / f32(n_out / n_in)
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kernel_scale
    w = _keys_cubic(x.astype(f32)).astype(f32)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0)).astype(f32)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def nearest_index(n_in: int, n_out: int) -> np.ndarray:
    """Input index of each output position of JAX's nearest resize."""
    offsets = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * np.float32(n_in) / np.float32(n_out)
    return np.floor(offsets.astype(np.float32)).astype(np.int64)


def bilinear_resize(x, size):
    """NCHW ``x`` to ``size`` with ``align_corners=True`` sampling, the JAX
    module's arithmetic (f32 positions, weights in x's dtype)."""
    _, _, h, w = x.shape
    hh, ww = size
    ys = torch.linspace(0.0, h - 1.0, hh, device=x.device)
    xs = torch.linspace(0.0, w - 1.0, ww, device=x.device)
    y0, x0 = ys.floor().long(), xs.floor().long()
    y1, x1 = (y0 + 1).clamp(0, h - 1), (x0 + 1).clamp(0, w - 1)
    wy = (ys - y0).to(x.dtype)[None, None, :, None]
    wx = (xs - x0).to(x.dtype)[None, None, None, :]
    rows0, rows1 = x[:, :, y0], x[:, :, y1]
    top = rows0[..., x0] * (1 - wx) + rows0[..., x1] * wx
    bot = rows1[..., x0] * (1 - wx) + rows1[..., x1] * wx
    return top * (1 - wy) + bot * wy


def cubic_resize(x, size):
    """NCHW ``x`` to ``size`` by :func:`cubic_weights` along each axis that
    changes (JAX resizes only those)."""
    _, _, h, w = x.shape
    hh, ww = size
    if hh != h:
        wy = torch.from_numpy(cubic_weights(h, hh)).to(x.device, x.dtype)
        x = torch.einsum("bchw,hH->bcHw", x, wy)
    if ww != w:
        wx = torch.from_numpy(cubic_weights(w, ww)).to(x.device, x.dtype)
        x = torch.einsum("bchw,wW->bchW", x, wx)
    return x


def nearest_resize(x, size):
    _, _, h, w = x.shape
    hh, ww = size
    if hh != h:
        x = x[:, :, torch.from_numpy(nearest_index(h, hh)).to(x.device)]
    if ww != w:
        x = x[..., torch.from_numpy(nearest_index(w, ww)).to(x.device)]
    return x


class BilinearUpsample(nn.Module):
    def __init__(self, in_channels: int = 0):
        super().__init__()

    def forward(self, x, size):
        return bilinear_resize(x, size)


class BicubicUpsample(nn.Module):
    def __init__(self, in_channels: int = 0):
        super().__init__()

    def forward(self, x, size):
        return cubic_resize(x, size)


def _same_pad(x, k: int):
    """flax ``padding="SAME"`` at stride 1: (k - 1) // 2 before, the rest
    after."""
    lo = (k - 1) // 2
    return F.pad(x, (lo, k - 1 - lo, lo, k - 1 - lo))


class NNConvUpsample2D(nn.Module):
    """Nearest resize, then two 4x4 convs at "SAME" padding (1 before, 2
    after, as flax pads an even kernel)."""

    def __init__(self, in_channels: int, dtype=torch.float32):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, in_channels, 4)
        self.conv2 = nn.Conv2d(in_channels, in_channels, 4)
        self.dtype = dtype

    def forward(self, x, size):
        x = nearest_resize(x, size)
        x = conv(_same_pad(x, 4), self.conv1, self.dtype)
        return conv(_same_pad(x, 4), self.conv2, self.dtype)


def get_upsample_l(kind: str):
    """upsample_layers.get_upsample_l (the 3d variant is flow-only legacy)."""
    table = {"bilinear": BilinearUpsample, "bicubic": BicubicUpsample, "nn2d": NNConvUpsample2D}
    if kind not in table:
        raise NotImplementedError(f"Upsample layer {kind} not implemented")
    return table[kind]


class SEBlock(nn.Module):
    """Squeeze-excite: mean over H, W, fc1 (no bias), leaky ReLU 0.01, fc2
    (no bias), sigmoid, scale."""

    def __init__(self, in_channels: int, r: int = 16, dtype=torch.float32):
        super().__init__()
        self.fc1 = nn.Linear(in_channels, in_channels // r, bias=False)
        self.fc2 = nn.Linear(in_channels // r, in_channels, bias=False)
        self.dtype = dtype

    def forward(self, x):
        dt = self.dtype
        y = x.mean(dim=(2, 3)).to(dt)
        y = F.leaky_relu(F.linear(y, self.fc1.weight.to(dt)), 0.01)
        y = torch.sigmoid(F.linear(y, self.fc2.weight.to(dt)))
        return x * y[:, :, None, None]


class Conv2dHeatmapCondition(nn.Module):
    """1x1-type conditioning: the heatmap's channels concatenated to the
    features, a 5x5 conv back to the feature width, leaky ReLU 0.01 (of the
    sum with the features where ``with_res``)."""

    def __init__(self, in_feature_channels: int, heatmap_channels: int = 1, dtype=torch.float32):
        super().__init__()
        self.conv2d = nn.Conv2d(in_feature_channels + heatmap_channels, in_feature_channels, 5, padding=2)
        self.dtype = dtype

    def forward(self, features, heatmap, with_res: bool = True):
        x = conv(torch.cat([features, heatmap.to(features.dtype)], dim=1), self.conv2d, self.dtype)
        return F.leaky_relu(x + features if with_res else x, 0.01)


class SqueezeHeatmapCondition(nn.Module):
    """se_block-type conditioning: features + SE(condition(features,
    heatmap) without the residual)."""

    def __init__(self, in_feature_channels: int, heatmap_channels: int = 1, dtype=torch.float32):
        super().__init__()
        self.conv2d = Conv2dHeatmapCondition(in_feature_channels, heatmap_channels, dtype)
        self.se_block = SEBlock(in_feature_channels, r=1, dtype=dtype)

    def forward(self, features, heatmap):
        return features + self.se_block(self.conv2d(features, heatmap, with_res=False))


def get_heatmap_cond_module(cond_module_args: dict, in_feature_channels: int):
    t = cond_module_args["type"]
    if t == "se_block":
        return SqueezeHeatmapCondition(in_feature_channels)
    if t == "1x1":
        return Conv2dHeatmapCondition(in_feature_channels)
    raise NotImplementedError(t)
