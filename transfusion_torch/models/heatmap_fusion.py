"""Legacy snao heatmap family: cross fusion over trunk features producing a
spatial next-active-object heatmap plus noun / verb / TTC heads (port of
``transfusion_tpu/models/heatmap_fusion.py``: ``HeatmapFusionConfig``,
``_RegroupHead``, ``HeatmapCrossFusion``).

The trunk map [B, h, w, C] (NHWC, as JAX takes it) is patchified into
``token_dim`` tokens; a learned heatmap token leads them (and a class token
follows in ``token_embeddings`` mode with a head on), then positions and an
image-kind embedding; the language tokens get a lang-kind embedding. Two
fusion families:

* ``cross_transformer``: [vis, lang] through ``num_layers`` post-norm
  :class:`~transfusion_torch.models.fusion.EncoderLayer` (plain attention:
  JAX calls it without ``use_flash``), norms on K1 (FusedLayerNorm);
* ``asymmetric``: per layer both streams query the concatenated memory
  from before the update (:class:`~transfusion_torch.models.
  fusion_variants.QKVEncoderLayer`, flax norms on K1); the language queries
  skip the heatmap token unless ``lang_to_hmap``.

The heatmap token (``back_to_img_fn: token``) or the patch tokens
(``regroup`` / ``regroup_gated``) go back to an [h, w] map; the class
features come off the language stream in embedding mode and off the class
token otherwise; with ``extra`` a Linear, exact GELU and a flax LayerNorm
(K1) follow. ``last_stage``: optional sigmoid, upsampling to ``im_size``,
log-softmax under ``kl_div``. At ``token_dim`` 300 (the GloVe narration
size) every norm runs K1's any-width path.

The port builds its layers before it sees an input, so its config adds
what JAX reads off the first input: ``feature_channels`` and
``feature_hw`` (the trunk map's C and (h, w)). Names are JAX's:
``patch_to_token``, ``heatmap_token``, ``class_token``, ``pos``,
``image_kind_embedding`` / ``lang_kind_embedding`` (JAX ``image_kind`` /
``lang_kind``), ``layers.i`` (``layer_i``), ``vis_layers.i`` /
``lang_layers.i`` (``vis_i`` / ``lang_i``), ``hmap_head.*``,
``class_post_linear``, ``class_post_ln`` and the heads.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from transfusion_torch.models.fusion import EncoderLayer, PositionalEmbedding
from transfusion_torch.models.fusion_variants import QKVEncoderLayer
from transfusion_torch.models.resnet import conv
from transfusion_torch.models.resnet_nao import class_heads, dense, last_stage
from transfusion_torch.models.text_encoder import dropout
from transfusion_torch.ops.layer_norm import FlaxLayerNorm


@dataclass(frozen=True)
class HeatmapFusionConfig:
    """CROSS_LAYER_ARGS / DEF_NARR_EMBED_ARGS (JAX's config; the effective
    default fusion is asymmetric) and the two input-shape fields above."""

    fusion_type: str = "asymmetric"
    narr_out_mode: str = "embedding"
    token_dim: int = 300
    patch_h: int = 2
    patch_w: int = 2
    patch_dropout: float = 0.2
    vis_layers: int = 3
    lang_layers: int = 2
    num_layers: int = 2
    num_heads: int = 2
    ff_multiplier: float = 2.0
    vis_dropout: float = 0.1
    lang_dropout: float = 0.1
    token_dropout: float = 0.1
    back_to_img_fn: str = "regroup_gated"
    extra: bool = True
    elu_last: bool = False
    pos_embedding: str = "learned"
    activation: str = "gelu"
    lang_to_hmap: bool = False
    heatmap_upscale: float = 1.0
    class_upscale: float = 1.0
    backproj_dropout: float = 0.1
    noun_classes: int = 0
    verb_classes: int = 0
    ttc_pred: bool = False
    kl_div: bool = False
    w_sigmoid: bool = False
    class_dropout: float = 0.2
    ttc_dropout: float = 0.2
    upsample_kind: str = "bilinear"
    feature_channels: int = 1024
    feature_hw: tuple = (48, 64)
    dtype: torch.dtype = torch.float32

    @property
    def classifying(self) -> bool:
        return self.noun_classes > 0 or self.verb_classes > 0

    @property
    def classif_token(self) -> bool:
        """A class token is appended in token_embeddings mode with a head on."""
        return self.narr_out_mode != "embedding" and (self.classifying or self.ttc_pred)


class RegroupHead(nn.Module):
    """hmap_token_postprocess: patch tokens -> per-patch pixels -> [B, h, w]
    (``regroup``, ``regroup_gated`` gated by the class features), or the
    heatmap token -> the whole map (``token``)."""

    def __init__(self, cfg: HeatmapFusionConfig):
        super().__init__()
        self.cfg = cfg
        d, ph, pw = cfg.token_dim, cfg.patch_h, cfg.patch_w
        fat = int(cfg.heatmap_upscale * d)
        fh, fw = cfg.feature_hw
        if cfg.back_to_img_fn == "token":
            self.back_proj = nn.Linear(d, fh * fw)
        elif cfg.back_to_img_fn == "regroup" and cfg.extra:
            self.linear_1 = nn.Linear(d, fat)
            self.linear_2 = nn.Linear(fat, ph * pw)
        elif cfg.back_to_img_fn == "regroup":
            self.linear = nn.Linear(d, ph * pw)
        elif cfg.back_to_img_fn == "regroup_gated":
            self.cls_f_linear = nn.Linear(d, fat)
            self.linear_1 = nn.Linear(d, fat)
            self.linear_2 = nn.Linear(fat, ph * pw)
        else:
            raise ValueError(f"back_to_img_fn {cfg.back_to_img_fn} not recognized")

    def forward(self, tokens, cls_f, rng=None):
        cfg = self.cfg
        dt, rate, train = cfg.dtype, cfg.backproj_dropout, self.training
        ph, pw = cfg.patch_h, cfg.patch_w
        fh, fw = cfg.feature_hw
        if cfg.back_to_img_fn == "token":
            return dense(dropout(tokens, rate, train, rng), self.back_proj, dt).reshape(-1, fh, fw)
        if cfg.back_to_img_fn == "regroup" and cfg.extra:
            x = dense(tokens, self.linear_1, dt)
            if not cfg.elu_last:
                x = 1.0 + F.elu(x)
            x = dense(dropout(x, rate, train, rng), self.linear_2, dt)
            if cfg.elu_last:
                x = 1.0 + F.elu(x)
        elif cfg.back_to_img_fn == "regroup":
            x = 1.0 + F.elu(dense(dropout(tokens, rate, train, rng), self.linear, dt))
        else:
            gate = torch.sigmoid(dense(cls_f, self.cls_f_linear, dt))
            x = dense(tokens, self.linear_1, dt) * gate[:, None, :]
            x = 1.0 + F.elu(dense(dropout(x, rate, train, rng), self.linear_2, dt))
        b, gh, gw = x.shape[0], fh // ph, fw // pw
        return x.reshape(b, gh, gw, ph, pw).permute(0, 1, 3, 2, 4).reshape(b, gh * ph, gw * pw)


class HeatmapCrossFusion(nn.Module):
    """forward(feat [B, h, w, C], lang_tokens [B, T, token_dim], lang_mask
    [B, T] (1 = real; None = all real), im_size=None, rng=None) ->
    {"heatmap", "noun_logits", "verb_logits", "ttc"}. T is 1 in embedding
    mode (the pooled narration vector)."""

    def __init__(self, cfg: HeatmapFusionConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d, dt = cfg.token_dim, cfg.dtype
        fh, fw = cfg.feature_hw
        if fh % cfg.patch_h or fw % cfg.patch_w:
            raise ValueError("feature dims must be divisible by the patch size")
        self.n_patches = (fh // cfg.patch_h) * (fw // cfg.patch_w)
        n_vis = 1 + self.n_patches + int(cfg.classif_token)
        self.patch_to_token = nn.Conv2d(cfg.feature_channels, d, (cfg.patch_h, cfg.patch_w),
                                        stride=(cfg.patch_h, cfg.patch_w), bias=False)
        self.heatmap_token = nn.Parameter(torch.randn(1, 1, d))
        if cfg.classif_token:
            self.class_token = nn.Parameter(torch.randn(1, 1, d))
        self.pos = PositionalEmbedding(d, n_vis, cfg.pos_embedding)
        self.image_kind_embedding = nn.Parameter(torch.randn(1, 1, d))
        self.lang_kind_embedding = nn.Parameter(torch.randn(1, 1, d))
        if cfg.fusion_type == "cross_transformer":
            self.layers = nn.ModuleList(
                EncoderLayer(d, cfg.num_heads, cfg.ff_multiplier, dtype=dt, use_flash=False,
                             dropout_rate=cfg.token_dropout, activation=cfg.activation)
                for _ in range(cfg.num_layers))
        elif cfg.fusion_type == "asymmetric":
            self.vis_layers = nn.ModuleList(
                QKVEncoderLayer(d, cfg.num_heads, cfg.ff_multiplier, dropout_rate=cfg.vis_dropout,
                                activation=cfg.activation, dtype=dt) for _ in range(cfg.vis_layers))
            self.lang_layers = nn.ModuleList(
                QKVEncoderLayer(d, cfg.num_heads, cfg.ff_multiplier, dropout_rate=cfg.lang_dropout,
                                activation=cfg.activation, dtype=dt) for _ in range(cfg.lang_layers))
        else:
            raise ValueError(f"{cfg.fusion_type=} not implemented")
        self.hmap_head = RegroupHead(cfg)
        heads_on = cfg.classifying or cfg.ttc_pred
        cdim = d
        if cfg.extra and heads_on:
            cdim = int(cfg.class_upscale * d)
            self.class_post_linear = nn.Linear(d, cdim)
            self.class_post_ln = FlaxLayerNorm(cdim, dtype=dt)
        if cfg.noun_classes:
            self.noun_classifier = nn.Linear(cdim, cfg.noun_classes)
        if cfg.verb_classes:
            self.verb_classifier = nn.Linear(cdim, cfg.verb_classes)
        if cfg.ttc_pred:
            self.ttc_predictor = nn.Linear(cdim, 1)
        if device is not None:
            self.to(device)

    def _fuse(self, vis, lang, pad, rng):
        cfg = self.cfg
        if cfg.fusion_type == "cross_transformer":
            x = torch.cat([vis, lang], dim=1)
            for layer in self.layers:
                x = layer(x, key_padding_mask=pad, rng=rng)
            n_vis = vis.shape[1]
            return x[:, :n_vis], x[:, n_vis:]
        for i, vis_layer in enumerate(self.vis_layers):
            # Both streams read the memory from before this step's update.
            mem = torch.cat([vis, lang], dim=1)
            new_lang = lang
            if i < cfg.lang_layers:
                if cfg.lang_to_hmap:
                    new_lang = self.lang_layers[i](lang, mem, pad, rng)
                else:
                    new_lang = self.lang_layers[i](lang, mem[:, 1:], pad[:, 1:], rng)
            vis, lang = vis_layer(vis, mem, pad, rng), new_lang
        return vis, lang

    def forward(self, feat, lang_tokens, lang_mask=None, im_size=None, rng=None):
        cfg = self.cfg
        b, h, w, _ = feat.shape
        if (h, w) != tuple(cfg.feature_hw):
            raise ValueError(f"feature map {h}x{w}, the model was built for {cfg.feature_hw}")
        d, dt, n = cfg.token_dim, cfg.dtype, self.n_patches
        t = lang_tokens.shape[1]
        if lang_mask is None:
            lang_mask = torch.ones(b, t, dtype=torch.int32, device=feat.device)
        vis = conv(feat.permute(0, 3, 1, 2), self.patch_to_token, dt)  # [B, d, gh, gw]
        vis = vis.flatten(2).transpose(1, 2)
        parts = [self.heatmap_token.expand(b, 1, d).to(vis.dtype), vis]
        if cfg.classif_token:
            parts.append(self.class_token.expand(b, 1, d).to(vis.dtype))
        vis = self.pos(torch.cat(parts, dim=1))
        vis = vis + self.image_kind_embedding
        vis = dropout(vis, cfg.patch_dropout, self.training, rng)
        lang = lang_tokens.to(vis.dtype) + self.lang_kind_embedding
        n_vis = vis.shape[1]
        pad = torch.cat([torch.zeros(b, n_vis, dtype=torch.bool, device=feat.device), lang_mask == 0], dim=1)
        vis_out, lang_out = self._fuse(vis, lang, pad, rng)

        hmap_in = vis_out[:, 0] if cfg.back_to_img_fn == "token" else vis_out[:, 1:n + 1]
        # Embedding mode: the class features come off the language stream.
        cls_f = vis_out[:, n + 1] if cfg.classif_token else lang_out[:, 0]
        heatmap = self.hmap_head(hmap_in, cls_f, rng)
        if cfg.extra and (cfg.classifying or cfg.ttc_pred):
            cls_f = self.class_post_ln(F.gelu(dense(cls_f, self.class_post_linear, dt)))
        return {"heatmap": last_stage(heatmap, cfg, im_size), **class_heads(self, cls_f, rng)}
