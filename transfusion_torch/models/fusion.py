"""Per-FPN-level vision-language cross fusion (port of
``transfusion_tpu/models/fusion.py``).

Each selected backbone map is patchified by a conv into tokens, given
sin1d positions and a learned image-kind embedding, concatenated with the
language tokens (plus a lang-kind embedding) and run through a post-norm
Transformer encoder; the visual tokens then get a final LayerNorm and are
re-projected and folded back into a feature map that replaces the backbone
map before the FPN.

Names follow the reference: ``cross_fusion_encoders.i`` holds the kind
embeddings, ``t_encoder.layers.j`` (torch ``TransformerEncoderLayer`` names)
and ``final_norm_layer``; the patch convs and back-projections live beside
it on the model (``patches_to_token.i``, ``tokens_to_features.i.linear``).

Attention takes kernels K2 (forward) and K3/K4 (backward) exactly where the
JAX model takes its Pallas kernels: no attention mask, ``use_flash`` set and
a sequence of at least 2048 tokens (``transfusion_tpu/models/fusion.py:161``);
in training K2 drops attention probabilities at ``token_dropout`` with a
seed drawn per layer and call from the step's ``DropoutRNG``. Shorter
levels take the plain path, which masks with -1e9 and scales in the compute
dtype as XLA's path does. norm1/norm2/final_norm run kernel K1 in eval and
in training, with a closed-form backward (:mod:`transfusion_torch.ops.layer_norm`).
Training mode also turns on the dropout sites of ``fusion.py:187-204,268,309``.
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
from transfusion_torch.ops.layer_norm import FusedLayerNorm

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
    """x + table[:n] for the sin1d table precomputed at MAX_NUM_PATCHES (the
    flagship's ``pos_embedding``)."""

    def __init__(self, dim: int, num_patches: int = MAX_NUM_PATCHES):
        super().__init__()
        self.register_buffer("table", torch.from_numpy(sin1d_table(num_patches, dim)),
                             persistent=False)

    def forward(self, x):
        return x + self.table[None, : x.shape[1]].to(x.dtype)


class MultiheadSelfAttention(nn.Module):
    """torch ``MultiheadAttention`` parameter names (packed in_proj)."""

    def __init__(self, dim: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)
        nn.init.xavier_uniform_(self.in_proj_weight)


class EncoderLayer(nn.Module):
    """torch ``nn.TransformerEncoderLayer``, post-norm, exact GELU, batch
    first; ``dropout_rate`` at its four sites in training mode."""

    def __init__(self, dim: int, num_heads: int, ff_multiplier: float = 2.0,
                 dtype=torch.float32, use_flash: bool = False, dropout_rate: float = 0.1):
        super().__init__()
        self.dim, self.num_heads, self.dtype = dim, num_heads, dtype
        self.use_flash, self.dropout_rate = use_flash, dropout_rate
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
            ctx = flash_attention_train(q, k, v, key_padding_mask, rate, seed).reshape(b, l, d)
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
        h = dropout(F.gelu(linear(x, self.linear1, dt)), rate, True, rng)
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


class CrossFusionLevel(nn.Module):
    """One level's joint encoder (``cross_fusion_encoders.i``). ``forward``
    takes the level's patch conv and back-projection from the model."""

    def __init__(self, token_dim: int, num_layers: int, num_heads: int, ff_multiplier: float,
                 patch_hw: tuple, vis_mask_type: str = "global", use_flash: bool = False,
                 dtype=torch.float32, token_dropout: float = 0.15, patch_dropout: float = 0.1,
                 backproj_dropout: float = 0.1):
        super().__init__()
        self.patch_hw, self.vis_mask_type, self.dtype = patch_hw, vis_mask_type, dtype
        self.patch_dropout, self.backproj_dropout = patch_dropout, backproj_dropout
        self.pos = PositionalEmbedding(token_dim)
        self.image_kind_embedding = nn.Parameter(torch.randn(1, 1, token_dim))
        self.lang_kind_embedding = nn.Parameter(torch.randn(1, 1, token_dim))
        self.t_encoder = _TEncoder([
            EncoderLayer(token_dim, num_heads, ff_multiplier, dtype, use_flash, token_dropout)
            for _ in range(num_layers)
        ])
        self.final_norm_layer = FusedLayerNorm(token_dim, dtype=dtype)

    def forward(self, feat, lang_tokens, lang_mask, patch_conv: nn.Conv2d,
                back_proj: RegroupPatches, rng=None):
        """feat [B, C, H, W] -> fused [B, C, H, W]; ``rng`` the step's
        DropoutRNG in training."""
        b, c, h, w = feat.shape
        ph, pw = self.patch_hw
        vis = conv(feat, patch_conv, self.dtype)            # [B, D, gh, gw]
        gh, gw = vis.shape[2:]
        n = gh * gw
        vis = self.pos(vis.flatten(2).transpose(1, 2))      # [B, n, D]
        vis = dropout(vis + self.image_kind_embedding, self.patch_dropout, self.training, rng)
        lang = lang_tokens + self.lang_kind_embedding
        # The first consumers (projections, norm1) cast to the compute dtype.
        x = torch.cat([vis, lang], dim=1).to(self.dtype)
        pad = torch.cat([torch.zeros((b, n), dtype=torch.bool, device=x.device), lang_mask == 0], 1)
        attn_mask = None
        vis_mask = visual_token_mask(gh, gw, self.vis_mask_type)
        if vis_mask is not None:
            total = x.shape[1]
            joint = np.zeros((total, total), bool)
            joint[:n, :n] = vis_mask
            attn_mask = torch.from_numpy(joint).to(x.device)
        for layer in self.t_encoder.layers:
            x = layer(x, key_padding_mask=pad, attn_mask=attn_mask, rng=rng)
        vis_out = dropout(self.final_norm_layer(x[:, :n]), self.backproj_dropout, self.training, rng)
        # RegroupPatchesLayerBox: linear -> fold with (C, ph, pw) channel blocks.
        y = linear(vis_out, back_proj.linear, self.dtype)
        y = y.reshape(b, gh, gw, c, ph, pw).permute(0, 3, 1, 4, 2, 5).reshape(b, c, gh * ph, gw * pw)
        if (gh * ph, gw * pw) != (h, w):
            # Maps whose sides are not patch multiples keep an unfused tail of zeros.
            y = F.pad(y, (0, w - gw * pw, 0, h - gh * ph))
        return y.contiguous(memory_format=torch.channels_last)
