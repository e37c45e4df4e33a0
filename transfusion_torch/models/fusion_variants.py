"""Fusion families beside the symmetric encoder (port of
``transfusion_tpu/models/fusion_variants.py``): the asymmetric QKV cross
attention (``cross_qkv_layers.py:19-81``, ``cross_f_box_asymm.py:10-121``),
the clip-feature early fusion (``cross_f_box_vis_language_wrapper.py``) and
the factorized space-time encoder (``cross_f_box_layers.py:169-268``). (The
encoder shared across levels is the model's ``shared_t_encoder``, handed to
each :class:`~transfusion_torch.models.fusion.CrossFusionLevel`.)

Every level here has the cross-transformer level's interface: it takes the
level's patch conv and back-projection from the model (``patches_to_token.i``,
``tokens_to_features.i``) and returns (fused map, language tokens). Their
LayerNorms are flax's, as in JAX: they run kernel K1 through
:class:`~transfusion_torch.ops.layer_norm.FlaxLayerNorm` (the residual form
where the norm takes a sum), in f32 where the stream is f32. Their attention
stays plain PyTorch, as JAX leaves it to XLA: the QKV cross attention, the
clip-feature and space-time encoder layers have no ``use_flash``. Dropout
draws from the step's ``DropoutRNG`` in training.
"""

from __future__ import annotations

import torch
from torch import nn

from transfusion_torch.models.fusion import (
    MAX_NUM_PATCHES,
    EncoderLayer,
    PositionalEmbedding,
    RegroupPatches,
    activation_fn,
    patchify,
    regroup,
)
from transfusion_torch.models.text_encoder import dropout, linear
from transfusion_torch.ops.layer_norm import FlaxLayerNorm


class QKVEncoderLayer(nn.Module):
    """Post-norm cross-attention block: queries from one stream, keys and
    values from a memory (QKVEncoder), ReLU feed-forward by default."""

    def __init__(self, dim: int, num_heads: int, ff_multiplier: float = 1.0,
                 dropout_rate: float = 0.1, activation: str = "relu", dtype=torch.float32):
        super().__init__()
        self.dim, self.num_heads, self.dtype, self.dropout_rate = dim, num_heads, dtype, dropout_rate
        self.act = activation_fn(activation)
        self.q_proj, self.k_proj, self.v_proj = (nn.Linear(dim, dim) for _ in range(3))
        self.out_proj = nn.Linear(dim, dim)
        self.linear1 = nn.Linear(dim, int(dim * ff_multiplier))
        self.linear2 = nn.Linear(int(dim * ff_multiplier), dim)
        self.norm1 = FlaxLayerNorm(dim, dtype=dtype)
        self.norm2 = FlaxLayerNorm(dim, dtype=dtype)

    def forward(self, q_in, memory, key_padding_mask=None, rng=None):
        b, lq, d = q_in.shape
        lk, dt, hd = memory.shape[1], self.dtype, self.dim // self.num_heads
        rate = self.dropout_rate if self.training else 0.0
        q = linear(q_in, self.q_proj, dt).reshape(b, lq, self.num_heads, hd)
        k = linear(memory, self.k_proj, dt).reshape(b, lk, self.num_heads, hd)
        v = linear(memory, self.v_proj, dt).reshape(b, lk, self.num_heads, hd)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / torch.tensor(hd ** 0.5, dtype=dt)
        if key_padding_mask is not None:
            scores = scores.masked_fill(key_padding_mask[:, None, None, :], -1e9)
        probs = dropout(torch.softmax(scores, dim=-1), rate, True, rng)
        ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, lq, d)
        x = self.norm1(q_in, residual=dropout(linear(ctx, self.out_proj, dt), rate, True, rng))
        h = dropout(self.act(linear(x, self.linear1, dt)), rate, True, rng)
        return self.norm2(x, residual=dropout(linear(h, self.linear2, dt), rate, True, rng))


class AsymmetricCrossFusionLevel(nn.Module):
    """One level of the interleaved asymmetric fusion
    (``cross_fusion_encoders.i``): both streams query the concatenated
    [vis, lang] memory, re-concatenated between layer pairs. The first pair
    runs the language layer first; the visual stream runs ``vis_layers``
    updates, the language stream ``lang_layers`` (vis_layers >= lang_layers
    >= 1). No final norm; the patch dropout is applied again before the
    back-projection."""

    def __init__(self, token_dim: int, vis_layers: int, lang_layers: int, num_heads: int,
                 ff_multiplier: float, patch_hw: tuple, vis_dropout: float = 0.1,
                 lang_dropout: float = 0.1, patch_dropout: float = 0.1,
                 pos_embedding: str = "sin1d", activation: str = "relu", dtype=torch.float32):
        super().__init__()
        if not 1 <= lang_layers <= vis_layers:
            # JAX's loop would index a missing visual layer (or none at all).
            raise ValueError(f"asymmetric fusion needs 1 <= lang_layers <= vis_layers, got "
                             f"lang_layers={lang_layers}, vis_layers={vis_layers}")
        self.patch_hw, self.patch_dropout, self.dtype = patch_hw, patch_dropout, dtype
        self.pos = PositionalEmbedding(token_dim, kind=pos_embedding)
        self.image_kind_embedding = nn.Parameter(torch.randn(1, 1, token_dim))
        self.lang_kind_embedding = nn.Parameter(torch.randn(1, 1, token_dim))
        self.vis_layers = nn.ModuleList([
            QKVEncoderLayer(token_dim, num_heads, ff_multiplier, vis_dropout, activation, dtype)
            for _ in range(vis_layers)])
        self.lang_layers = nn.ModuleList([
            QKVEncoderLayer(token_dim, num_heads, ff_multiplier, lang_dropout, activation, dtype)
            for _ in range(lang_layers)])

    def forward(self, feat, lang_tokens, lang_mask, patch_conv: nn.Conv2d,
                back_proj: RegroupPatches, rng=None, visual_features=None):
        if visual_features is not None:
            # build_transfusion_config refuses the combination up front.
            raise ValueError("asymmetric fusion does not take visual_features")
        b = feat.shape[0]
        vis, grid = patchify(feat, patch_conv, self.dtype)
        vis = self.pos(vis)  # no grid: sin2d raises here, as in JAX
        vis = dropout(vis + self.image_kind_embedding, self.patch_dropout, self.training, rng)
        lang = lang_tokens + self.lang_kind_embedding
        pad = torch.cat([torch.zeros((b, vis.shape[1]), dtype=torch.bool, device=vis.device),
                         lang_mask == 0], 1)
        memory = torch.cat([vis, lang], 1)
        lang = self.lang_layers[0](lang, memory, pad, rng)
        vis = self.vis_layers[0](vis, memory, pad, rng)
        for i in range(1, len(self.vis_layers)):
            memory = torch.cat([vis, lang], 1)
            vis = self.vis_layers[i](vis, memory, pad, rng)
            if i < len(self.lang_layers):
                lang = self.lang_layers[i](lang, memory, pad, rng)
        vis = dropout(vis, self.patch_dropout, self.training, rng)
        return regroup(vis, back_proj, feat.shape, grid, self.patch_hw, self.dtype), lang


class VisualFeatureFusion(nn.Module):
    """Early vision-vision fusion with precomputed clip features
    (``vis_fusion.i``): the clip sequence [B, T, F] is L2-normalised (norm
    clipped at 1e-12), projected to the token dim without bias, given
    learned positions over ``max_frames``, and encoded jointly with the
    level's patch tokens by ``num_layers`` GELU encoder layers. Returns
    (patch half, clip half); the level keeps the patch half."""

    def __init__(self, token_dim: int, feature_dim: int, num_layers: int = 2, num_heads: int = 4,
                 ff_multiplier: float = 2.0, dropout_rate: float = 0.1,
                 pos_embedding: str = "learned", max_frames: int = 32, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.proj = nn.Linear(feature_dim, token_dim, bias=False)
        self.pos = PositionalEmbedding(token_dim, max_frames, pos_embedding)
        self.layers = nn.ModuleList([
            EncoderLayer(token_dim, num_heads, ff_multiplier, dtype, False, dropout_rate, "gelu")
            for _ in range(num_layers)])

    def forward(self, patch_tokens, clip_features, rng=None):
        norm = clip_features / torch.clamp(torch.linalg.vector_norm(clip_features, dim=-1, keepdim=True),
                                           min=1e-12)
        aux = self.pos(linear(norm, self.proj, self.dtype))
        n = patch_tokens.shape[1]
        x = torch.cat([patch_tokens, aux], 1)
        for layer in self.layers:
            x = layer(x, rng=rng)
        return x[:, :n], x[:, n:]


class SpaceTimeFusionLayer(nn.Module):
    """Factorized attention over [B, T, S, D]: an encoder layer over S at
    each t, added to its input a second time (the layer's output is already
    residual), then one over T at each s, added likewise, transposed back
    to [B, T, S, D]."""

    def __init__(self, dim: int, num_heads: int = 4, ff_multiplier: float = 2.0,
                 dropout_rate: float = 0.1, activation: str = "relu", dtype=torch.float32):
        super().__init__()
        self.spatial = EncoderLayer(dim, num_heads, ff_multiplier, dtype, False, dropout_rate, activation)
        self.temporal = EncoderLayer(dim, num_heads, ff_multiplier, dtype, False, dropout_rate,
                                     activation)

    def forward(self, x, rng=None):
        b, t, s, d = x.shape
        x = x + self.spatial(x.reshape(b * t, s, d), rng=rng).reshape(b, t, s, d)
        xt = x.transpose(1, 2).reshape(b * s, t, d)
        return (xt + self.temporal(xt, rng=rng)).reshape(b, s, t, d).transpose(1, 2)


class SpaceTimeFusionModule(nn.Module):
    """Positions (over T*S, no grid: ``sin2d`` raises) and an image-kind
    embedding, patch dropout, ``num_layers`` space-time layers and a final
    LayerNorm under ``final_norm: ln``, on [B, T, S, D]."""

    def __init__(self, dim: int, num_layers: int = 2, num_heads: int = 4, ff_multiplier: float = 2.0,
                 token_dropout: float = 0.1, patch_dropout: float = 0.1, activation: str = "relu",
                 pos_embedding: str = "sin1d", final_norm: str = "ln", dtype=torch.float32):
        super().__init__()
        self.patch_dropout = patch_dropout
        self.pos = PositionalEmbedding(dim, MAX_NUM_PATCHES, pos_embedding)
        self.image_kind_embedding = nn.Parameter(torch.randn(1, 1, 1, dim))
        self.layers = nn.ModuleList([
            SpaceTimeFusionLayer(dim, num_heads, ff_multiplier, token_dropout, activation, dtype)
            for _ in range(num_layers)])
        self.final_norm = FlaxLayerNorm(dim, dtype=dtype) if final_norm == "ln" else None

    def forward(self, x, rng=None):
        b, t, s, d = x.shape
        x = self.pos(x.reshape(b, t * s, d)).reshape(b, t, s, d)
        x = dropout(x + self.image_kind_embedding, self.patch_dropout, self.training, rng)
        for layer in self.layers:
            x = layer(x, rng)
        return x if self.final_norm is None else self.final_norm(x)


class SpaceTimeFusionLevel(nn.Module):
    """The fusion YAML's ``type: space_time`` (``cross_fusion_encoders.i``):
    the patch grid factorized as rows x columns and encoded by a
    :class:`SpaceTimeFusionModule` (``encoder``), re-projected as the
    cross-transformer level does. The module takes no language: the
    language tokens pass through unchanged."""

    def __init__(self, token_dim: int, num_layers: int, num_heads: int, ff_multiplier: float,
                 patch_hw: tuple, token_dropout: float = 0.1, patch_dropout: float = 0.1,
                 backproj_dropout: float = 0.1, activation: str = "relu",
                 pos_embedding: str = "sin1d", final_norm: str = "ln", dtype=torch.float32):
        super().__init__()
        self.patch_hw, self.backproj_dropout, self.dtype = patch_hw, backproj_dropout, dtype
        self.encoder = SpaceTimeFusionModule(token_dim, num_layers, num_heads, ff_multiplier,
                                             token_dropout, patch_dropout, activation, pos_embedding,
                                             final_norm, dtype)

    def forward(self, feat, lang_tokens, lang_mask, patch_conv: nn.Conv2d,
                back_proj: RegroupPatches, rng=None, visual_features=None):
        if visual_features is not None:
            raise ValueError("space_time fusion does not take visual_features")
        b = feat.shape[0]
        vis, (gh, gw) = patchify(feat, patch_conv, self.dtype)
        x = self.encoder(vis.reshape(b, gh, gw, -1), rng).reshape(b, gh * gw, -1)
        vis_out = dropout(x, self.backproj_dropout, self.training, rng)
        return regroup(vis_out, back_proj, feat.shape, (gh, gw), self.patch_hw, self.dtype), lang_tokens
