"""Feature Pyramid Network (port of ``transfusion_tpu/models/fpn.py``):
torchvision ``FeaturePyramidNetwork`` + ``LastLevelMaxPool``, with the
reference's ``inner_blocks``/``layer_blocks`` names. NCHW tensors."""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from transfusion_torch.models.resnet import conv


class FPN(nn.Module):
    def __init__(self, in_channels, out_channels: int = 256, dtype=None):
        super().__init__()
        self.inner_blocks = nn.ModuleList([nn.Conv2d(c, out_channels, 1) for c in in_channels])
        self.layer_blocks = nn.ModuleList(
            [nn.Conv2d(out_channels, out_channels, 3, padding=1) for _ in in_channels]
        )
        self.dtype = dtype

    def forward(self, feats: dict) -> dict:
        keys = sorted(feats.keys(), key=int)
        laterals = [conv(feats[k], self.inner_blocks[i], self.dtype) for i, k in enumerate(keys)]
        merged = [None] * len(laterals)
        merged[-1] = laterals[-1]
        for i in range(len(laterals) - 2, -1, -1):
            up = F.interpolate(merged[i + 1], size=laterals[i].shape[-2:], mode="nearest")
            merged[i] = laterals[i] + up
        out = {k: conv(merged[i], self.layer_blocks[i], self.dtype) for i, k in enumerate(keys)}
        # LastLevelMaxPool: kernel 1, stride 2.
        out["pool"] = F.max_pool2d(out[keys[-1]], 1, stride=2)
        return out
