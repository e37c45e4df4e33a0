"""Plain-ResNet snao model: heatmap and/or classification over a truncated
trunk, the legacy non-fusion baseline of the heatmap family (port of
``transfusion_tpu/models/resnet_nao.py``).

A torchvision ResNet (``stride_in_1x1=False``: the stride on the 3x3 conv,
not the detector's detectron2 placement) cut after ``heatmap_blocks``
stages feeds a one-channel heatmap head; classification keeps the
remaining stages and average-pools into Dropout + Linear noun / verb heads
and a softplus TTC head. In heatmap-only mode the tail stages are not built.
Under ``multivar_n`` the heatmap slot holds a 2-D Gaussian's parameters
from a 5-way linear layer over the flattened head map, with the intended
index split loc [:2], tril [2], diag [3:]. ``last_stage``: optional
sigmoid, upsampling to the input resolution, log-softmax under ``kl_div``.

Images are NHWC [B, H, W, 3] as the JAX model takes them; the trunk runs in
NCHW (channels-last memory). Names: the trunk torchvision's (``conv1``,
``bn1``, ``layerN.i.convK`` / ``bnK`` / ``downsample.{0,1}``); the rest
JAX's (``heatmap_head.conv{1,2}``, ``noun_classifier``, ``verb_classifier``,
``ttc_predictor``, ``dist_mlp``, ``offset_stds``). Dropout draws from the
train step's ``DropoutRNG`` (``rng``) in training mode.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from transfusion_torch.models.misc_layers import get_upsample_l
from transfusion_torch.models.resnet import Bottleneck, FrozenBatchNorm2d, conv
from transfusion_torch.models.text_encoder import dropout


@dataclass(frozen=True)
class ResnetNaoConfig:
    """ResnetWrapper's arguments and the criterion-derived flags (JAX's
    ``ResnetNaoConfig``). ``resize_spec`` (H, W) sets the multivar layer's
    input width, prod(resize_spec // 2**(heatmap_blocks + 1))."""

    stage_sizes: Sequence[int] = (3, 4, 6, 3)
    heatmap_blocks: int = 3
    noun_classes: int = 0
    verb_classes: int = 0
    ttc_pred: bool = False
    heatmap_pred: bool = True
    multivar_n: bool = False
    w_sigmoid: bool = False
    kl_div: bool = False
    class_dropout: float = 0.2
    ttc_dropout: float = 0.2
    hmap_dropout: float = 0.25
    head_k_size: int = 3
    hmap_head_upscale: float = 1.0
    upsample_kind: str = "bilinear"
    resize_spec: Sequence[int] = (192, 384)
    dtype: torch.dtype = torch.float32

    @property
    def classifying(self) -> bool:
        return self.noun_classes > 0 or self.verb_classes > 0

    @property
    def downsample_factor(self) -> int:
        return 2 ** (self.heatmap_blocks + 1)


def dense(x, mod: nn.Linear, dtype):
    """A Dense layer in the compute dtype, the f32 parameters cast at use."""
    return F.linear(x.to(dtype), mod.weight.to(dtype), None if mod.bias is None else mod.bias.to(dtype))


class HeatmapHead(nn.Module):
    """The supplied one-channel head: k x k conv to round(in_ch * upscale)
    channels (Python's round), ReLU, Dropout, 1x1 conv to one channel;
    returns [B, H, W]."""

    def __init__(self, in_ch: int, upscale: float = 1.0, k: int = 3, dropout_rate: float = 0.25,
                 dtype=torch.float32):
        super().__init__()
        hidden = max(1, int(round(in_ch * upscale)))
        self.conv1 = nn.Conv2d(in_ch, hidden, k, padding=(k - 1) // 2)
        self.conv2 = nn.Conv2d(hidden, 1, 1)
        self.dropout_rate, self.dtype = dropout_rate, dtype

    def forward(self, x, rng=None):
        x = F.relu(conv(x, self.conv1, self.dtype))
        x = dropout(x, self.dropout_rate, self.training, rng)
        return conv(x, self.conv2, self.dtype)[:, 0]


class NaoHeads(nn.Module):
    """The heads and ``last_stage`` JAX's ResnetNao and ScnnNao share, on
    the model itself (no name prefix): the heatmap head (and the multivar
    layer over its map), the Dropout + Linear noun / verb heads and the
    softplus TTC head."""

    def build_heads(self, cfg, feat_ch: int, cls_ch: int, hmap_hw: tuple):
        if cfg.heatmap_pred:
            self.heatmap_head = HeatmapHead(feat_ch, cfg.hmap_head_upscale, cfg.head_k_size,
                                            cfg.hmap_dropout, cfg.dtype)
            if cfg.multivar_n:
                self.dist_mlp = nn.Linear(int(np.prod(hmap_hw)), 5)
                self.offset_stds = nn.Parameter(torch.ones(2))
        if cfg.noun_classes:
            self.noun_classifier = nn.Linear(cls_ch, cfg.noun_classes)
        if cfg.verb_classes:
            self.verb_classifier = nn.Linear(cls_ch, cfg.verb_classes)
        if cfg.ttc_pred:
            self.ttc_predictor = nn.Linear(cls_ch, 1)

    def forward_multivar(self, hm, rng=None):
        """forward_multivar with the intended split: loc [:2], tril [2],
        diag 1 + offset_stds + elu([3:])."""
        b = hm.shape[0]
        flat = dropout(hm.reshape(b, -1), self.cfg.hmap_dropout, self.training, rng)
        out = dense(flat, self.dist_mlp, torch.float32)
        loc, tril, diag = out[:, :2], out[:, 2], out[:, 3:]
        diag = 1.0 + self.offset_stds + F.elu(diag)
        zeros = torch.zeros(b, dtype=diag.dtype, device=diag.device)
        scale_tril = torch.stack([diag[:, 0], zeros, tril, diag[:, 1]], dim=-1).reshape(b, 2, 2)
        return {"loc": loc, "scale_tril": scale_tril}

    def heads(self, feat, cls_f, im_size, rng=None):
        cfg = self.cfg
        heatmap = None
        if cfg.heatmap_pred:
            hm = self.heatmap_head(feat, rng)
            heatmap = self.forward_multivar(hm, rng) if cfg.multivar_n else last_stage(hm, cfg, im_size)
        return {"heatmap": heatmap, **class_heads(self, cls_f, rng)}


def class_heads(model, cls_f, rng=None) -> dict:
    """get_dnn's Dropout + Linear noun and verb heads and the softplus TTC
    head of ``model`` (its ``cfg`` flags and rates) over ``cls_f``; None
    where a head is off."""
    cfg = model.cfg

    def head(mod, rate):
        return dense(dropout(cls_f, rate, model.training, rng), mod, cfg.dtype)

    return {"noun_logits": head(model.noun_classifier, cfg.class_dropout) if cfg.noun_classes else None,
            "verb_logits": head(model.verb_classifier, cfg.class_dropout) if cfg.verb_classes else None,
            "ttc": F.softplus(head(model.ttc_predictor, cfg.ttc_dropout))[:, 0] if cfg.ttc_pred else None}


def last_stage(x, cfg, im_size):
    """Optional sigmoid, upsampling of [B, h, w] to ``im_size`` in f32
    (where it differs), log-softmax over the flattened map under kl_div."""
    if cfg.w_sigmoid:
        x = torch.sigmoid(x)
    if im_size is not None and tuple(im_size) != tuple(x.shape[1:3]):
        x = get_upsample_l(cfg.upsample_kind)(1)(x[:, None].float(), tuple(im_size))[:, 0]
    if cfg.kl_div:
        b, hh, wh = x.shape
        x = F.log_softmax(x.reshape(b, -1).float(), dim=-1).reshape(b, hh, wh)
    return x


class ResnetNao(NaoHeads):
    """forward(images NHWC, rng=None) -> {"heatmap", "noun_logits",
    "verb_logits", "ttc"}; under ``multivar_n`` the heatmap slot is
    {"loc": [B, 2], "scale_tril": [B, 2, 2]}."""

    def __init__(self, cfg: ResnetNaoConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm2d(64)
        n_stages = len(cfg.stage_sizes) if (cfg.classifying or cfg.ttc_pred) else cfg.heatmap_blocks
        cin, mid = 64, 64
        for stage in range(n_stages):
            stride = 1 if stage == 0 else 2
            blocks = []
            for b in range(cfg.stage_sizes[stage]):
                blocks.append(Bottleneck(cin, mid, stride if b == 0 else 1, stride_in_1x1=False,
                                         project=(b == 0), dtype=cfg.dtype))
                cin = mid * 4
            if stage + 1 == cfg.heatmap_blocks:
                feat_ch = cin
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
            mid *= 2
        self.n_stages = n_stages
        hw = tuple(int(s) // cfg.downsample_factor for s in cfg.resize_spec)
        self.build_heads(cfg, feat_ch, cin, hw)
        if device is not None:
            self.to(device)

    def forward(self, images, rng=None):
        cfg = self.cfg
        x = images.permute(0, 3, 1, 2)
        h = F.relu(self.bn1(conv(x, self.conv1, cfg.dtype)))
        h = F.max_pool2d(h, 3, stride=2, padding=1)
        feat = None
        for stage in range(self.n_stages):
            h = getattr(self, f"layer{stage + 1}")(h)
            if stage + 1 == cfg.heatmap_blocks:
                feat = h
        cls_f = h.mean(dim=(2, 3)) if (cfg.classifying or cfg.ttc_pred) else None
        return self.heads(feat, cls_f, images.shape[1:3], rng)
