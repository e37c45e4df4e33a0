"""Dual-stream (RGB + optical flow) ResNet body (port of
``transfusion_tpu/models/dual_stream.py``), the backbone of
``DetectorConfig(dual_stream=True)``.

The motion feature is fused into every residual block's input; a
projecting shortcut reads the fused input while an identity shortcut reads
the input from before the fusion (JAX ``dual_stream.py:74-80``). The motion
stream is a thin ResNet over the 2-channel flow: a 7x7/s2 stem and max
pool, then one projecting bottleneck a stage at quarter width, so each
stage's motion feature matches the RGB block inputs' resolution. Block 0 of
a stage still sits at the previous resolution (its stride lives inside the
block), so it fuses the motion feature from before the stage (JAX
``:118-136``).

Names: the RGB trunk keeps the ResNet body's (``conv1``/``bn1``,
``layerN.i.*``) and adds ``layerN.i.fuse.proj``; the motion stream is
``flow_conv1``/``flow_bn1`` and ``flow_layerN`` (a bottleneck:
``conv1-3``/``bn1-3``, ``downsample.{0,1}``). Frozen BatchNorm throughout,
as JAX's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from transfusion_torch.models.resnet import Bottleneck, FrozenBatchNorm2d, conv


class FlowFusion(nn.Module):
    """fusion_fn(x, extra): ``sum`` adds a 1x1 projection of the motion
    feature to x; ``concat`` projects [x, motion] back to x's width."""

    def __init__(self, c: int, c_motion: int, kind: str = "sum", dtype=torch.float32):
        super().__init__()
        if kind not in ("sum", "concat"):
            raise ValueError(f"flow fusion kind {kind!r} not implemented")
        self.proj = nn.Conv2d(c + c_motion if kind == "concat" else c_motion, c, 1, bias=False)
        self.kind, self.dtype = kind, dtype

    def forward(self, x, extra):
        if self.kind == "sum":
            return x + conv(extra, self.proj, self.dtype)
        return conv(torch.cat([x, extra.to(x.dtype)], dim=1), self.proj, self.dtype)


class DualBottleneck(Bottleneck):
    """A bottleneck with the motion feature fused at its input."""

    def __init__(self, cin: int, c_motion: int, mid: int, stride: int, stride_in_1x1: bool,
                 project: bool, fusion: str = "sum", dtype=torch.float32):
        super().__init__(cin, mid, stride, stride_in_1x1, project, dtype)
        self.fuse = FlowFusion(cin, c_motion, fusion, dtype)

    def forward(self, x, extra, train: bool = False):
        return self.forward_from(self.fuse(x, extra), x, train)


class DualStreamResNet(nn.Module):
    """forward(images NCHW, flow NCHW [B, 2, H, W]) -> {"0".."3"}, the
    ResNet body's stage dict."""

    def __init__(self, stage_sizes=(3, 4, 6, 3), stride_in_1x1: bool = True, fusion: str = "sum",
                 flow_width: int = 16, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm2d(64)
        self.flow_conv1 = nn.Conv2d(2, flow_width, 7, stride=2, padding=3, bias=False)
        self.flow_bn1 = FrozenBatchNorm2d(flow_width)
        cin, mid, fcin, fmid = 64, 64, flow_width, flow_width
        self.num_stages = len(stage_sizes)
        for stage, blocks in enumerate(stage_sizes):
            stride = 1 if stage == 0 else 2
            self.add_module(f"flow_layer{stage + 1}",
                            Bottleneck(fcin, fmid, stride, stride_in_1x1, True, dtype))
            layer = []
            for b in range(blocks):
                layer.append(DualBottleneck(cin, fcin if b == 0 else fmid * 4, mid,
                                            stride if b == 0 else 1, stride_in_1x1, b == 0, fusion,
                                            dtype))
                cin = mid * 4
            self.add_module(f"layer{stage + 1}", nn.Sequential(*layer))
            fcin = fmid * 4
            mid, fmid = mid * 2, fmid * 2

    def forward(self, images, flow, train: bool = False):
        dt = self.dtype
        h = F.max_pool2d(F.relu(self.bn1(conv(images, self.conv1, dt))), 3, stride=2, padding=1)
        m = F.max_pool2d(F.relu(self.flow_bn1(conv(flow, self.flow_conv1, dt))), 3, stride=2, padding=1)
        feats = {}
        for i in range(self.num_stages):
            m_in = m
            m = getattr(self, f"flow_layer{i + 1}")(m, train)
            for b, block in enumerate(getattr(self, f"layer{i + 1}")):
                h = block(h, m_in if b == 0 else m, train)
            feats[str(i)] = h
        return feats
