"""ResNet-50 body with detectron2 strides and frozen BatchNorm (port of
``transfusion_tpu/models/resnet.py``, plain 7x7 stem only).

Module and buffer names follow torchvision's ``resnet_fpn_backbone`` body
(``conv1``/``bn1``/``layerN.i.convK``/``bnK``/``downsample.{0,1}``) so the
state dict is the reference checkpoint's. Tensors are NCHW in the
channels-last memory format; weights stay f32 and are cast to the compute
dtype at use, as the JAX modules do.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

RESNET50_CHANNELS = {"0": 256, "1": 512, "2": 1024, "3": 2048}


def conv(x, conv_mod: nn.Conv2d, dtype):
    """A conv in the compute dtype with the f32 parameters cast at use."""
    w = conv_mod.weight.to(dtype)
    b = None if conv_mod.bias is None else conv_mod.bias.to(dtype)
    return F.conv2d(x.to(dtype), w, b, conv_mod.stride, conv_mod.padding)


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

    def forward(self, x):
        mul = self.weight / torch.sqrt(self.running_var + self.eps)
        add = self.bias - self.running_mean * mul
        return x * mul.to(x.dtype)[None, :, None, None] + add.to(x.dtype)[None, :, None, None]


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1 (x4) with a projection shortcut on the first block."""

    def __init__(self, cin: int, mid: int, stride: int, stride_in_1x1: bool, project: bool, dtype):
        super().__init__()
        s1, s2 = (stride, 1) if stride_in_1x1 else (1, stride)
        self.conv1 = nn.Conv2d(cin, mid, 1, stride=s1, bias=False)
        self.bn1 = FrozenBatchNorm2d(mid)
        self.conv2 = nn.Conv2d(mid, mid, 3, stride=s2, padding=1, bias=False)
        self.bn2 = FrozenBatchNorm2d(mid)
        self.conv3 = nn.Conv2d(mid, mid * 4, 1, bias=False)
        self.bn3 = FrozenBatchNorm2d(mid * 4)
        self.downsample = (
            nn.Sequential(nn.Conv2d(cin, mid * 4, 1, stride=stride, bias=False),
                          FrozenBatchNorm2d(mid * 4))
            if project else None
        )
        self.dtype = dtype

    def forward(self, x):
        dt = self.dtype
        h = F.relu(self.bn1(conv(x, self.conv1, dt)))
        h = F.relu(self.bn2(conv(h, self.conv2, dt)))
        h = self.bn3(conv(h, self.conv3, dt))
        sc = x if self.downsample is None else self.downsample[1](conv(x, self.downsample[0], dt))
        return F.relu(h + sc)


class ResNet(nn.Module):
    """forward(x NCHW) -> {"0": C2, "1": C3, "2": C4, "3": C5} (strides 4..32)."""

    def __init__(self, stage_sizes=(3, 4, 6, 3), stride_in_1x1: bool = True, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm2d(64)
        cin, mid = 64, 64
        self.stage_names = []
        for stage, blocks in enumerate(stage_sizes):
            stride = 1 if stage == 0 else 2
            layer = []
            for b in range(blocks):
                layer.append(Bottleneck(cin, mid, stride if b == 0 else 1, stride_in_1x1,
                                        project=(b == 0), dtype=dtype))
                cin = mid * 4
            name = f"layer{stage + 1}"
            self.add_module(name, nn.Sequential(*layer))
            self.stage_names.append(name)
            mid *= 2

    def forward(self, x):
        h = F.relu(self.bn1(conv(x, self.conv1, self.dtype)))
        h = F.max_pool2d(h, 3, stride=2, padding=1)
        feats = {}
        for i, name in enumerate(self.stage_names):
            h = getattr(self, name)(h)
            feats[str(i)] = h
        return feats
