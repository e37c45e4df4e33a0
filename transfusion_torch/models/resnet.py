"""ResNet-50 body with detectron2 strides and frozen or trainable BatchNorm
(port of ``transfusion_tpu/models/resnet.py``), with the plain 7x7 stem or
the space-to-depth stem.

Module and buffer names follow torchvision's ``resnet_fpn_backbone`` body
(``conv1``/``bn1``/``layerN.i.convK``/``bnK``/``downsample.{0,1}``) so the
state dict is the reference checkpoint's. Tensors are NCHW in the
channels-last memory format; weights stay f32 and are cast to the compute
dtype at use, as the JAX modules do. ``stop_grad_prefix`` cuts the tape
after the first units [stem, layer1..layer4] as the JAX package's
``stop_gradient`` does (resnet.py:178-199): a cut unit and everything before
it run without autograd, which gives the same gradients (nothing upstream of
the cut trains) without recording the tape; at 5, the flagship's, the whole
body runs without one.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from transfusion_torch.ops.batch_norm import BatchNorm

RESNET50_CHANNELS = {"0": 256, "1": 512, "2": 1024, "3": 2048}


def conv(x, conv_mod: nn.Conv2d, dtype):
    """A conv in the compute dtype with the f32 parameters cast at use."""
    w = conv_mod.weight.to(dtype)
    b = None if conv_mod.bias is None else conv_mod.bias.to(dtype)
    return F.conv2d(x.to(dtype), w, b, conv_mod.stride, conv_mod.padding, conv_mod.dilation,
                    conv_mod.groups)


def fold_stem_to_s2d(w):
    """Exactly regroup standard stem weights [7, 7, C, 64] (HWIO) into the
    space-to-depth stem's [4, 4, 4*C, 64]: output pixel i of the 7x7/s2 conv
    reads input u = 2i - 3 + dy; writing u = 2(a + i - 2) + p maps kernel tap
    dy = 2*alpha + p - 1 (alpha = a - i + 2 in [0, 4)), taps outside [0, 7)
    are zero. Same along x. s2d channel layout is (p, q, c) flattened. (A
    copy of ``transfusion_tpu/models/resnet.py::fold_stem_to_s2d``.)"""
    kh, kw, c, o = w.shape
    assert (kh, kw) == (7, 7)
    out = np.zeros((4, 4, 4 * c, o), np.asarray(w).dtype)
    for alpha in range(4):
        for p in range(2):
            dy = 2 * alpha + p - 1
            if not 0 <= dy < 7:
                continue
            for beta in range(4):
                for q in range(2):
                    dx = 2 * beta + q - 1
                    if not 0 <= dx < 7:
                        continue
                    s = (p * 2 + q) * c
                    out[alpha, beta, s : s + c] = np.asarray(w)[dy, dx]
    return out


def fold_stem_weight(w: torch.Tensor) -> torch.Tensor:
    """:func:`fold_stem_to_s2d` in the port's layout: a plain stem's
    ``conv1.weight`` [64, C, 7, 7] (OIHW) -> ``stem_s2d.weight`` [64, 4C, 4, 4]."""
    hwio = w.detach().cpu().float().numpy().transpose(2, 3, 1, 0)
    return torch.from_numpy(np.ascontiguousarray(fold_stem_to_s2d(hwio).transpose(3, 2, 0, 1)))


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """NCHW ``x`` [B, C, H, W] -> [B, 4C, H/2, W/2] with channel order
    (p, q, c): pixel (2i + p, 2j + q) channel c lands at (i, j) channel
    (2p + q) C + c. The rearrangement runs in NHWC, so one copy of an NHWC
    (channels-last) input gives a channels-last result, the layout the stem
    conv reads."""
    b, c, hh, ww = x.shape
    nhwc = x.permute(0, 2, 3, 1).reshape(b, hh // 2, 2, ww // 2, 2, c)
    s2d = nhwc.permute(0, 1, 3, 2, 4, 5).reshape(b, hh // 2, ww // 2, 4 * c)
    return s2d.permute(0, 3, 1, 2)


class FrozenBatchNorm2d(nn.Module):
    """y = (x - mean) / sqrt(var + eps) * weight + bias with fixed buffers,
    folded into one multiply-add (f32 fold, applied in the compute dtype)."""

    def __init__(self, c: int, eps: float = 1e-5):
        super().__init__()
        self.register_buffer("weight", torch.ones(c))
        self.register_buffer("bias", torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.eps = eps

    def forward(self, x, train: bool = False):
        mul = self.weight / torch.sqrt(self.running_var + self.eps)
        add = self.bias - self.running_mean * mul
        return x * mul.to(x.dtype)[None, :, None, None] + add.to(x.dtype)[None, :, None, None]


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1 (x4) with a projection shortcut on the first block."""

    def __init__(self, cin: int, mid: int, stride: int, stride_in_1x1: bool, project: bool, dtype,
                 norm=FrozenBatchNorm2d):
        super().__init__()
        s1, s2 = (stride, 1) if stride_in_1x1 else (1, stride)
        self.conv1 = nn.Conv2d(cin, mid, 1, stride=s1, bias=False)
        self.bn1 = norm(mid)
        self.conv2 = nn.Conv2d(mid, mid, 3, stride=s2, padding=1, bias=False)
        self.bn2 = norm(mid)
        self.conv3 = nn.Conv2d(mid, mid * 4, 1, bias=False)
        self.bn3 = norm(mid * 4)
        self.downsample = (
            nn.Sequential(nn.Conv2d(cin, mid * 4, 1, stride=stride, bias=False), norm(mid * 4))
            if project else None
        )
        self.dtype = dtype

    def forward(self, x, train: bool = False):
        return self.forward_from(x, x, train)

    def forward_from(self, x, identity, train: bool = False):
        """The block over ``x`` with ``identity`` as the shortcut where it
        does not project (the dual-stream block's pre-fusion input)."""
        dt = self.dtype
        h = F.relu(self.bn1(conv(x, self.conv1, dt), train))
        h = F.relu(self.bn2(conv(h, self.conv2, dt), train))
        h = self.bn3(conv(h, self.conv3, dt), train)
        sc = (identity if self.downsample is None
              else self.downsample[1](conv(x, self.downsample[0], dt), train))
        return F.relu(h + sc)


class ResNet(nn.Module):
    """forward(x NCHW) -> {"0": C2, "1": C3, "2": C4, "3": C5} (strides 4..32)."""

    def __init__(self, stage_sizes=(3, 4, 6, 3), stride_in_1x1: bool = True, dtype=torch.float32,
                 stop_grad_prefix: int = 0, trainable_bn: bool = False, bn_momentum: float = 0.1,
                 s2d_stem: bool = False):
        super().__init__()
        self.dtype, self.stop_grad_prefix, self.s2d_stem = dtype, stop_grad_prefix, s2d_stem
        norm = (lambda c: BatchNorm(c, bn_momentum)) if trainable_bn else FrozenBatchNorm2d
        if s2d_stem:
            # JAX pads ((2, 1), (2, 1)); the conv pads 2 on both sides and
            # the extra last row and column are sliced off.
            self.stem_s2d = nn.Conv2d(12, 64, 4, padding=2, bias=False)
        else:
            self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = norm(64)
        cin, mid = 64, 64
        self.stage_names = []
        for stage, blocks in enumerate(stage_sizes):
            stride = 1 if stage == 0 else 2
            layer = []
            for b in range(blocks):
                layer.append(Bottleneck(cin, mid, stride if b == 0 else 1, stride_in_1x1,
                                        project=(b == 0), dtype=dtype, norm=norm))
                cin = mid * 4
            name = f"layer{stage + 1}"
            self.add_module(name, nn.Sequential(*layer))
            self.stage_names.append(name)
            mid *= 2

    def _tape(self, unit: int):
        """No autograd for unit ``unit`` (0 = stem) when the cut is past it."""
        return torch.no_grad() if unit < self.stop_grad_prefix else contextlib.nullcontext()

    def stem_conv(self, x):
        """The stem conv of NCHW ``x`` in the compute dtype: 7x7/s2, or the
        s2d rearrangement (after the cast, as JAX casts first) and its
        4x4/s1 conv."""
        if not self.s2d_stem:
            return conv(x, self.conv1, self.dtype)
        _, _, hh, ww = x.shape
        h = conv(space_to_depth(x.to(self.dtype)), self.stem_s2d, self.dtype)
        return h[:, :, : hh // 2, : ww // 2]

    def forward(self, x, train: bool = False):
        with self._tape(0):
            h = F.relu(self.bn1(self.stem_conv(x), train))
            h = F.max_pool2d(h, 3, stride=2, padding=1)
        feats = {}
        for i, name in enumerate(self.stage_names):
            with self._tape(i + 1):
                for block in getattr(self, name):
                    h = block(h, train)
            feats[str(i)] = h
        return feats


def batch_stats(model: nn.Module) -> dict | None:
    """{name: buffer} of the trainable BatchNorms' running averages (the
    live tensors, not copies), None where the model has none."""
    out = {f"{name}.{b}": getattr(mod, b) for name, mod in model.named_modules()
           if isinstance(mod, BatchNorm) for b in ("running_mean", "running_var")}
    return out or None
