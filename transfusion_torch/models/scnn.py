"""Fast-SCNN snao model: the two-branch real-time trunk with heatmap and
classification heads, the lightweight member of the legacy heatmap family
(port of ``transfusion_tpu/models/scnn.py``).

Learning to downsample (a 3x3/s2 ConvBN and two depthwise-separable convs,
1/8 resolution), the global feature extractor (three stacks of MobileNetV2
linear bottlenecks, strides 2, 2, 1, over the port's
``mobilenet.InvertedResidual`` with ``use_se=False`` and ReLU) with pyramid
pooling, and the feature fusion (the global branch upsampled bilinearly,
depthwise-refined, both branches projected to the fusion width, summed,
ReLU). The classification branch adds two bottleneck stacks (3 blocks to
int(1.25 C) at stride 2, 1 block to ``out_class_channels``) and pools. The
heads and ``last_stage`` are ResnetNao's (:class:`~transfusion_torch.
models.resnet_nao.NaoHeads`). Every ConvBN is the frozen-BN MobileNet one
(eps 1e-3).

Pyramid pooling pools with kernel = stride = ``h // bins`` (at least 1) in
floor mode, as flax's ``avg_pool`` with VALID padding does: not adaptive
pooling (at 768x1024 the 1/32 map is 24x32, so bins 3 takes 8x10 windows
and gives 3x3).

Images are NHWC; maps NCHW. Names are JAX's: ``trunk.{ltd_conv, ltd_ds1,
ltd_ds2, gfe{i}.{b}, ppm.pool{i}, ppm.project, ff_dwconv, ff_low,
ff_high}``, ``bottleneck_1.{b}``, ``bottleneck_2.0`` and the heads', each
ConvBN's conv and norm at ``.0`` / ``.1`` and an InvertedResidual's parts
at ``.block.{j}``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from transfusion_torch.models.misc_layers import bilinear_resize
from transfusion_torch.models.mobilenet import ConvBN, InvertedResidual
from transfusion_torch.models.resnet_nao import NaoHeads


@dataclass(frozen=True)
class ScnnNaoConfig:
    """The factory's widths (scnn_wrapper.py:96-104) and the heads' flags
    (JAX's ``ScnnNaoConfig``). ``resize_spec`` (H, W) sets the multivar
    layer's input width, the fused map's ceil(H / 8) x ceil(W / 8) (a field
    the port adds: its layers are built before they see an input)."""

    downsample_c: Sequence[int] = (24, 32, 48)
    feature_extractor_c: Sequence[int] = (48, 64, 96)
    num_blocks: Sequence[int] = (3, 3, 3)
    feature_fusion_c: Sequence[int] = (48, 96, 96)
    out_class_channels: int = 512
    noun_classes: int = 0
    verb_classes: int = 0
    ttc_pred: bool = False
    heatmap_pred: bool = True
    multivar_n: bool = False
    w_sigmoid: bool = False
    kl_div: bool = False
    class_dropout: float = 0.25
    ttc_dropout: float = 0.25
    hmap_dropout: float = 0.25
    head_k_size: int = 3
    hmap_head_upscale: float = 1.0
    upsample_kind: str = "bilinear"
    resize_spec: Sequence[int] = (192, 384)
    dtype: torch.dtype = torch.float32

    @property
    def classifying(self) -> bool:
        return self.noun_classes > 0 or self.verb_classes > 0


class DSConv(nn.Module):
    """3x3 depthwise ConvBN + ReLU, 1x1 ConvBN + ReLU."""

    def __init__(self, cin: int, features: int, stride: int = 1, dtype=torch.float32):
        super().__init__()
        self.depthwise = ConvBN(cin, cin, 3, stride, groups=cin, activation="relu", dtype=dtype)
        self.pointwise = ConvBN(cin, features, 1, 1, activation="relu", dtype=dtype)

    def forward(self, x):
        return self.pointwise(self.depthwise(x))


class PyramidPooling(nn.Module):
    """Average pools over {1, 2, 3, 6} bins, each to C/4 by a 1x1 ConvBN
    and bilinearly upsampled back (in f32), concatenated with the input and
    projected to ``features``."""

    BINS = (1, 2, 3, 6)

    def __init__(self, cin: int, features: int, dtype=torch.float32):
        super().__init__()
        branch = features // 4
        for i in range(len(self.BINS)):
            setattr(self, f"pool{i}", ConvBN(cin, branch, 1, 1, activation="relu", dtype=dtype))
        self.project = ConvBN(cin + len(self.BINS) * branch, features, 1, 1, activation="relu", dtype=dtype)

    def forward(self, x):
        _, _, h, w = x.shape
        outs = [x]
        for i, bins in enumerate(self.BINS):
            kh, kw = max(h // bins, 1), max(w // bins, 1)
            p = getattr(self, f"pool{i}")(F.avg_pool2d(x, (kh, kw), stride=(kh, kw)))
            outs.append(bilinear_resize(p.float(), (h, w)).to(x.dtype))
        return self.project(torch.cat(outs, dim=1))


def bottleneck_stack(cin: int, out: int, blocks: int, t: int, stride: int, dtype) -> nn.Sequential:
    """_make_layer(LinearBottleneck, ...): the first block carries the
    stride, the rest are stride-1 residuals."""
    layers = []
    for b in range(blocks):
        layers.append(InvertedResidual(cin, 3, t * cin, out, False, "relu", stride if b == 0 else 1, dtype))
        cin = out
    return nn.Sequential(*layers)


class ScnnFeatures(nn.Module):
    """The Fast-SCNN trunk: NCHW images -> the fused 1/8-resolution map."""

    def __init__(self, cfg: ScnnNaoConfig):
        super().__init__()
        dt = cfg.dtype
        c0, c1, c2 = cfg.downsample_c
        self.ltd_conv = ConvBN(3, c0, 3, 2, activation="relu", dtype=dt)
        self.ltd_ds1 = DSConv(c0, c1, 2, dt)
        self.ltd_ds2 = DSConv(c1, c2, 2, dt)
        cin = c2
        for i, (c, n) in enumerate(zip(cfg.feature_extractor_c, cfg.num_blocks)):
            setattr(self, f"gfe{i}", bottleneck_stack(cin, c, n, 6, 2 if i < 2 else 1, dt))
            cin = c
        self.ppm = PyramidPooling(cin, cfg.feature_extractor_c[-1], dt)
        g = cfg.feature_extractor_c[-1]
        fuse_out = cfg.feature_fusion_c[-1]
        self.ff_dwconv = ConvBN(g, g, 3, 1, groups=g, activation="relu", dtype=dt)
        self.ff_low = ConvBN(g, fuse_out, 1, 1, activation=None, dtype=dt)
        self.ff_high = ConvBN(c2, fuse_out, 1, 1, activation=None, dtype=dt)
        self.n_gfe = len(cfg.feature_extractor_c)

    def forward(self, x):
        high_res = self.ltd_ds2(self.ltd_ds1(self.ltd_conv(x)))
        g = high_res
        for i in range(self.n_gfe):
            g = getattr(self, f"gfe{i}")(g)
        g = self.ppm(g)
        low = bilinear_resize(g.float(), tuple(high_res.shape[2:])).to(g.dtype)
        low = self.ff_low(self.ff_dwconv(low))
        return F.relu(low + self.ff_high(high_res))


class ScnnNao(NaoHeads):
    """SCNNWrapper's forward: fused trunk features -> heatmap branch +
    classification branch -> last_stage; ResnetNao's output contract."""

    def __init__(self, cfg: ScnnNaoConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.trunk = ScnnFeatures(cfg)
        feat_ch = cfg.feature_fusion_c[-1]
        cls_ch = feat_ch
        if cfg.classifying or cfg.ttc_pred:
            mid = int(feat_ch * 1.25)
            self.bottleneck_1 = bottleneck_stack(feat_ch, mid, 3, 4, 2, cfg.dtype)
            self.bottleneck_2 = bottleneck_stack(mid, cfg.out_class_channels, 1, 4, 1, cfg.dtype)
            cls_ch = cfg.out_class_channels
        hw = tuple(math.ceil(int(s) / 8) for s in cfg.resize_spec)
        self.build_heads(cfg, feat_ch, cls_ch, hw)
        if device is not None:
            self.to(device)

    def forward(self, images, rng=None):
        cfg = self.cfg
        feat = self.trunk(images.permute(0, 3, 1, 2))
        cls_f = None
        if cfg.classifying or cfg.ttc_pred:
            c = F.relu(self.bottleneck_1(feat))
            c = F.relu(self.bottleneck_2(c))
            cls_f = c.mean(dim=(2, 3))
        return self.heads(feat, cls_f, images.shape[1:3], rng)
