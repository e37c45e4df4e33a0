"""Per-FPN-level vision-language cross fusion and the LM auxiliary head
(port of ``transfusion_tpu/models/fusion.py``).

Each selected backbone map is patchified by a conv into tokens, given
positions (sin1d, sin2d over the patch grid, learned or zero) and a learned
image-kind embedding, concatenated with the language tokens (plus a
lang-kind embedding) and run through a post-norm Transformer encoder (its
own layers, or a stack the model shares across levels); the visual tokens
then get a final LayerNorm (``final_norm: ln``) and are re-projected and
folded back into a feature map that replaces the backbone map before the
FPN. A level returns the map and its fused language tokens, which the
model may forward to the next level and the LM head (:class:`PoolPredictor`)
classifies.

Names follow the reference: ``cross_fusion_encoders.i`` holds the kind
embeddings, ``pos.pos_embedding`` (learned or zero positions),
``t_encoder.layers.j`` (torch ``TransformerEncoderLayer`` names) and
``final_norm_layer``; the patch convs and back-projections live beside it
on the model (``patches_to_token.i``, ``tokens_to_features.i.linear``), as
does the LM head (``lm_layer.{ln,mlp_noun,mlp_verb}``).

Attention takes kernels K2 (forward) and K3/K4 (backward) exactly where the
JAX model takes its Pallas kernels: no attention mask, ``use_flash`` set and
a sequence of at least 2048 tokens (``transfusion_tpu/models/fusion.py:161``);
in training K2 drops attention probabilities at ``token_dropout`` with a
seed drawn per layer and call from the step's ``DropoutRNG``. Shorter
levels take the plain path, which masks with -1e9 and scales in the compute
dtype as XLA's path does. norm1/norm2/final_norm run kernel K1 in eval and
in training, with a closed-form backward (:mod:`transfusion_torch.ops.layer_norm`),
and so does the LM head's ``ln``. Training mode also turns on the dropout
sites of ``fusion.py:187-204,268,309``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from transfusion_torch.models.resnet import conv
from transfusion_torch.models.text_encoder import dropout, linear, need_rng
from transfusion_torch.ops.attention import flash_attention_train
from transfusion_torch.ops.layer_norm import FlaxLayerNorm, FusedLayerNorm

MAX_NUM_PATCHES = 8192
FLASH_MIN_LEN = 2048


def sin1d_table(n: int, dim: int) -> np.ndarray:
    """Sine/cosine positional table [n, dim]."""
    position = np.arange(n, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, dim, 2, dtype=np.float32) * (-math.log(10000.0) / dim))
    pe = np.zeros((n, dim), np.float32)
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div)
    return pe


def sin2d_table(h: int, w: int, dim: int) -> np.ndarray:
    """2D sine/cosine table [h*w, dim]: the first half of the channels
    encodes the column, the second half the row."""
    if dim % 4 != 0:
        raise ValueError("sin2d requires dim % 4 == 0")
    half = dim // 2
    div = np.exp(np.arange(0, half, 2, dtype=np.float32) * (-math.log(10000.0) / half))
    pe = np.zeros((dim, h, w), np.float32)
    pos_w = np.arange(w, dtype=np.float32)[:, None]
    pos_h = np.arange(h, dtype=np.float32)[:, None]
    pe[0:half:2] = np.sin(pos_w * div).T[:, None, :].repeat(h, axis=1)
    pe[1:half:2] = np.cos(pos_w * div).T[:, None, :].repeat(h, axis=1)
    pe[half::2] = np.sin(pos_h * div).T[:, :, None].repeat(w, axis=2)
    pe[half + 1 :: 2] = np.cos(pos_h * div).T[:, :, None].repeat(w, axis=2)
    return pe.reshape(dim, -1).T


def visual_token_mask(gh: int, gw: int, mask_type: str) -> np.ndarray | None:
    """[N, N] bool, True = blocked: ``local_k`` keeps the Chebyshev-k window
    around each visual token; ``global`` -> None."""
    if mask_type == "global":
        return None
    if "local" not in mask_type:
        raise NotImplementedError(f"unknown vis_mask_type {mask_type}")
    k = int(mask_type.split("_")[-1])
    rows = np.arange(gh * gw) // gw
    cols = np.arange(gh * gw) % gw
    near_r = np.abs(rows[:, None] - rows[None, :]) <= k
    near_c = np.abs(cols[:, None] - cols[None, :]) <= k
    return ~(near_r & near_c)


class PositionalEmbedding(nn.Module):
    """x + table[:n] of the fusion YAML's ``pos_embedding`` kind: ``sin1d``
    precomputed at ``num_patches``; ``sin2d`` over the patch grid the caller
    passes as ``grid_hw``; ``learned`` (normal(1.0) at init) or ``zero``
    (zeros at init), a parameter ``pos_embedding`` [num_patches, dim]."""

    def __init__(self, dim: int, num_patches: int = MAX_NUM_PATCHES, kind: str = "sin1d"):
        super().__init__()
        if kind not in ("sin1d", "sin2d", "learned", "zero"):
            raise ValueError(f"unknown pos embedding {kind}")
        self.dim, self.kind = dim, kind
        self._sin2d: dict = {}
        if kind == "sin1d":
            self.register_buffer("table", torch.from_numpy(sin1d_table(num_patches, dim)),
                                 persistent=False)
        elif kind in ("learned", "zero"):
            init = torch.randn if kind == "learned" else torch.zeros
            self.pos_embedding = nn.Parameter(init(num_patches, dim))

    def forward(self, x, grid_hw: tuple | None = None):
        if self.kind == "sin2d":
            if grid_hw is None:
                raise ValueError("sin2d positional embedding needs grid_hw")
            key = (tuple(grid_hw), x.device)
            if key not in self._sin2d:
                self._sin2d[key] = torch.from_numpy(sin2d_table(*grid_hw, self.dim)).to(x.device)
            table = self._sin2d[key]
        else:
            table = self.table if self.kind == "sin1d" else self.pos_embedding
        return x + table[None, : x.shape[1]].to(x.dtype)


class MultiheadSelfAttention(nn.Module):
    """torch ``MultiheadAttention`` parameter names (packed in_proj)."""

    def __init__(self, dim: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)
        nn.init.xavier_uniform_(self.in_proj_weight)


def activation_fn(name: str):
    """The feed-forward activation: exact GELU for ``gelu``, ReLU for any
    other name (the JAX layers' rule)."""
    return F.gelu if name == "gelu" else F.relu


class EncoderLayer(nn.Module):
    """torch ``nn.TransformerEncoderLayer``, post-norm, exact GELU (ReLU for
    another ``activation``), batch first; ``dropout_rate`` at its four sites
    in training mode."""

    def __init__(self, dim: int, num_heads: int, ff_multiplier: float = 2.0,
                 dtype=torch.float32, use_flash: bool = False, dropout_rate: float = 0.1,
                 activation: str = "gelu"):
        super().__init__()
        self.dim, self.num_heads, self.dtype = dim, num_heads, dtype
        self.use_flash, self.dropout_rate = use_flash, dropout_rate
        self.act = activation_fn(activation)
        self.self_attn = MultiheadSelfAttention(dim)
        self.linear1 = nn.Linear(dim, int(dim * ff_multiplier))
        self.linear2 = nn.Linear(int(dim * ff_multiplier), dim)
        self.norm1 = FusedLayerNorm(dim, dtype=dtype)
        self.norm2 = FusedLayerNorm(dim, dtype=dtype)

    def forward(self, x, key_padding_mask=None, attn_mask=None, rng=None):
        b, l, d = x.shape
        dt, hd = self.dtype, self.dim // self.num_heads
        w = self.self_attn.in_proj_weight.to(dt)
        bias = self.self_attn.in_proj_bias.to(dt)
        xd = x.to(dt)
        q, k, v = (F.linear(xd, w[i * d:(i + 1) * d], bias[i * d:(i + 1) * d])
                   .reshape(b, l, self.num_heads, hd) for i in range(3))
        rate = self.dropout_rate if self.training else 0.0
        if attn_mask is None and self.use_flash and l >= FLASH_MIN_LEN:
            seed = need_rng(rng).attention_seed() if rate > 0.0 else 0
            offset = rng.batch_offset if rate > 0.0 else 0
            ctx = flash_attention_train(q, k, v, key_padding_mask, rate, seed,
                                        offset).reshape(b, l, d)
        else:
            scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / torch.tensor(hd ** 0.5, dtype=dt)
            if key_padding_mask is not None:
                scores = scores.masked_fill(key_padding_mask[:, None, None, :], -1e9)
            if attn_mask is not None:
                scores = scores.masked_fill(attn_mask[None, None], -1e9)
            probs = dropout(torch.softmax(scores, dim=-1), rate, True, rng)
            ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, l, d)
        attn_out = dropout(linear(ctx, self.self_attn.out_proj, dt), rate, True, rng)
        x = self.norm1(x, residual=attn_out)
        h = dropout(self.act(linear(x, self.linear1, dt)), rate, True, rng)
        h = dropout(linear(h, self.linear2, dt), rate, True, rng)
        return self.norm2(x, residual=h)


class _TEncoder(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class RegroupPatches(nn.Module):
    """``tokens_to_features.i``: Linear(token_dim, C*ph*pw), folded."""

    def __init__(self, token_dim: int, out_channels: int, ph: int, pw: int):
        super().__init__()
        self.linear = nn.Linear(token_dim, out_channels * ph * pw)


def patchify(feat, patch_conv: nn.Conv2d, dtype):
    """feat [B, C, H, W] -> (patch tokens [B, gh*gw, D], (gh, gw)) through
    the level's conv (kernel = stride = patch size, no bias)."""
    vis = conv(feat, patch_conv, dtype)                 # [B, D, gh, gw]
    return vis.flatten(2).transpose(1, 2), tuple(vis.shape[2:])


def regroup(vis_out, back_proj: RegroupPatches, feat_shape, grid, patch_hw, dtype):
    """RegroupPatchesLayerBox: tokens [B, gh*gw, D] -> Linear -> fold with
    (C, ph, pw) channel blocks -> [B, C, H, W] (channels-last); a map whose
    sides are not patch multiples keeps an unfused tail of zeros."""
    b, c, h, w = feat_shape
    (gh, gw), (ph, pw) = grid, patch_hw
    y = linear(vis_out, back_proj.linear, dtype)
    y = y.reshape(b, gh, gw, c, ph, pw).permute(0, 3, 1, 4, 2, 5).reshape(b, c, gh * ph, gw * pw)
    if (gh * ph, gw * pw) != (h, w):
        y = F.pad(y, (0, w - gw * pw, 0, h - gh * ph))
    return y.contiguous(memory_format=torch.channels_last)


class CrossFusionLevel(nn.Module):
    """One level's joint encoder (``cross_fusion_encoders.i``). ``forward``
    takes the level's patch conv and back-projection from the model and,
    where the model has them, the encoder layers it shares across levels
    (``num_layers`` is then 0 here) and the level's clip-feature fusion."""

    def __init__(self, token_dim: int, num_layers: int, num_heads: int, ff_multiplier: float,
                 patch_hw: tuple, vis_mask_type: str = "global", use_flash: bool = False,
                 dtype=torch.float32, token_dropout: float = 0.15, patch_dropout: float = 0.1,
                 backproj_dropout: float = 0.1, pos_embedding: str = "sin1d",
                 final_norm: str = "ln", activation: str = "gelu"):
        super().__init__()
        self.patch_hw, self.vis_mask_type, self.dtype = patch_hw, vis_mask_type, dtype
        self.patch_dropout, self.backproj_dropout = patch_dropout, backproj_dropout
        self.pos = PositionalEmbedding(token_dim, kind=pos_embedding)
        self.image_kind_embedding = nn.Parameter(torch.randn(1, 1, token_dim))
        self.lang_kind_embedding = nn.Parameter(torch.randn(1, 1, token_dim))
        self.t_encoder = _TEncoder([
            EncoderLayer(token_dim, num_heads, ff_multiplier, dtype, use_flash, token_dropout,
                         activation)
            for _ in range(num_layers)
        ])
        self.final_norm_layer = FusedLayerNorm(token_dim, dtype=dtype) if final_norm == "ln" else None

    def forward(self, feat, lang_tokens, lang_mask, patch_conv: nn.Conv2d,
                back_proj: RegroupPatches, rng=None, visual_features=None,
                shared_layers=None, vis_fusion=None):
        """feat [B, C, H, W] -> (fused [B, C, H, W], fused language tokens
        [B, L, D]); ``rng`` the step's DropoutRNG in training; clip features
        [B, T, F] go through ``vis_fusion`` when both are given."""
        b, n_lang = feat.shape[0], lang_tokens.shape[1]
        vis, (gh, gw) = patchify(feat, patch_conv, self.dtype)
        n = gh * gw
        vis = self.pos(vis, grid_hw=(gh, gw))               # [B, n, D]
        vis = dropout(vis + self.image_kind_embedding, self.patch_dropout, self.training, rng)
        if vis_fusion is not None and visual_features is not None:
            vis, _ = vis_fusion(vis, visual_features, rng)
        lang = lang_tokens + self.lang_kind_embedding
        # The first consumers (projections, norm1) cast to the compute dtype.
        x = torch.cat([vis, lang], dim=1).to(self.dtype)
        pad = torch.cat([torch.zeros((b, n), dtype=torch.bool, device=x.device), lang_mask == 0], 1)
        attn_mask = None
        vis_mask = visual_token_mask(gh, gw, self.vis_mask_type)
        if vis_mask is not None:
            joint = np.zeros((n + n_lang, n + n_lang), bool)
            joint[:n, :n] = vis_mask
            attn_mask = torch.from_numpy(joint).to(x.device)
        for layer in self.t_encoder.layers if shared_layers is None else shared_layers:
            x = layer(x, key_padding_mask=pad, attn_mask=attn_mask, rng=rng)
        vis_out, lang_out = x[:, :n], x[:, n:]
        if self.final_norm_layer is not None:
            vis_out = self.final_norm_layer(vis_out)
        vis_out = dropout(vis_out, self.backproj_dropout, self.training, rng)
        return regroup(vis_out, back_proj, feat.shape, (gh, gw), self.patch_hw, self.dtype), lang_out


class PoolPredictor(nn.Module):
    """The LM auxiliary head (``lm_layer``): the language tokens with masked
    positions zeroed, then max or mean over all L (not a masked mean: the
    zeros count, and a zero can win the max) -> LayerNorm (``use_ln``) ->
    noun and verb logits (background classes excluded; ``num_verbs`` 0
    leaves the verb head out). The norm runs kernel K1."""

    def __init__(self, dim: int, num_nouns: int, num_verbs: int, pooling: str = "mean",
                 use_ln: bool = True, dtype=torch.float32):
        super().__init__()
        self.pooling, self.dtype = pooling, dtype
        self.ln = FlaxLayerNorm(dim, dtype=dtype) if use_ln else None
        self.mlp_noun = nn.Linear(dim, num_nouns)
        self.mlp_verb = nn.Linear(dim, num_verbs) if num_verbs else None

    def forward(self, lang_tokens, lang_mask=None):
        x = lang_tokens
        if lang_mask is not None:
            x = x * lang_mask[..., None].to(x.dtype)
        feats = x.amax(1) if self.pooling == "max" else x.mean(1)
        if self.ln is not None:
            feats = self.ln(feats)
        verb = None if self.mlp_verb is None else linear(feats, self.mlp_verb, self.dtype)
        return {"noun_logits": linear(feats, self.mlp_noun, self.dtype), "verb_logits": verb}
