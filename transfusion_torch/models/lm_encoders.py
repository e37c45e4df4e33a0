"""GPT-2 and T5 encoder-only narration towers (port of
``transfusion_tpu/models/lm_encoders.py``): distilgpt2 with its LM head
removed, and the T5 encoder stack (t5 v1.0 with a ReLU feed-forward, flan-t5
with the gated GELU one), each under :class:`PooledLMEncoder`, which returns
the tokens or their masked mean L2-normalised, through ``out_mlp``, an
optional tanh and dropout.

Parameter names are huggingface's under the reference's
``narr_pooling_layer.encoder`` prefix, so
``transfusion_tpu/tools/translate_checkpoint.py`` reads the port's state
dict without a new mapping: GPT-2 ``transformer.{wte, wpe, h.i.{ln_1,
attn.c_attn, attn.c_proj, ln_2, mlp.c_fc, mlp.c_proj}, ln_f}`` with the
Conv1D weight layout [in, out]; T5 ``shared`` and ``encoder.{block.i.layer.0
.{SelfAttention.{q, k, v, o, relative_attention_bias}, layer_norm},
block.i.layer.1.{DenseReluDense.{wi | wi_0, wi_1, wo}, layer_norm},
final_layer_norm}`` (bias-free ``nn.Linear``; the bias table in block 0).

Numerics follow the JAX modules: attention is plain tensor ops (64 tokens
with a causal or padding mask, as JAX's einsums in XLA), masked scores are
-1e9, the softmax and the GELUs go op by op in the compute dtype with
their constants rounded to it, as JAX evaluates them, T5 does not scale by 1/sqrt(d) and block 0's relative position bias
serves every block. GPT-2's LayerNorms are flax's (eps 1e-5) and run kernel
K1 through :func:`flax_layer_norm`; T5's ``RMSNorm`` stays plain PyTorch and
multiplies by its f32 scale, so under bf16 compute its output is f32, as
JAX's promotion gives. Dropout draws from the step's ``DropoutRNG``.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from transfusion_torch.models.text_encoder import dropout, flax_layer_norm, linear, mean_pool

# --------------------------------------------------------------------- GPT-2


@dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    hidden_size: int = 768
    num_layers: int = 6  # distilgpt2
    num_heads: int = 12
    max_positions: int = 1024
    layer_norm_eps: float = 1e-5
    dropout: float = 0.1


@functools.cache
def _const(value: float, dtype) -> float:
    """A Python constant as JAX's weak typing applies it to an array of
    ``dtype``: rounded to that dtype first (torch would apply it unrounded)."""
    return torch.tensor(value, dtype=dtype).item()


def gelu_new(x):
    """GPT-2's tanh-approximated gelu, op by op in x's dtype as JAX computes
    it."""
    c0, c1 = _const(0.7978845608028654, x.dtype), _const(0.044715, x.dtype)
    return 0.5 * x * (1.0 + torch.tanh(c0 * (x + c1 * x ** 3)))


def gelu_tanh(x):
    """``jax.nn.gelu(x, approximate=True)`` (flan-t5's gated feed-forward),
    op by op in x's dtype."""
    c0, c1 = _const(math.sqrt(2 / math.pi), x.dtype), _const(0.044715, x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(c0 * (x + c1 * x ** 3))))


def softmax(x):
    """``flax.linen.softmax`` over the last dim, op by op in x's dtype: the
    exponentials, their sum and the quotient are each rounded to it."""
    e = torch.exp(x - x.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


class Conv1D(nn.Module):
    """huggingface GPT-2's Conv1D: ``weight`` [in, out] (flax's kernel
    layout), ``bias`` [out]."""

    def __init__(self, nin: int, nout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(nin, nout))
        self.bias = nn.Parameter(torch.zeros(nout))
        nn.init.normal_(self.weight, std=0.02)

    def forward(self, x, dtype):
        return torch.matmul(x.to(dtype), self.weight.to(dtype)) + self.bias.to(dtype)


class _GPT2Attention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.c_attn = Conv1D(d, 3 * d)
        self.c_proj = Conv1D(d, d)


class _GPT2MLP(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.c_fc = Conv1D(d, 4 * d)
        self.c_proj = Conv1D(4 * d, d)


class GPT2Block(nn.Module):
    """Pre-norm block: causal self-attention and the gelu_new MLP."""

    def __init__(self, c: GPT2Config, dtype=torch.float32):
        super().__init__()
        d = c.hidden_size
        self.cfg, self.dtype = c, dtype
        self.ln_1 = nn.LayerNorm(d, eps=c.layer_norm_eps)
        self.attn = _GPT2Attention(d)
        self.ln_2 = nn.LayerNorm(d, eps=c.layer_norm_eps)
        self.mlp = _GPT2MLP(d)

    def forward(self, x, attention_mask, rng=None):
        c, dt = self.cfg, self.dtype
        b, l, d = x.shape
        hd = d // c.num_heads
        h = flax_layer_norm(x, self.ln_1, dt)
        q, k, v = (t.reshape(b, l, c.num_heads, hd) for t in self.attn.c_attn(h, dt).split(d, -1))
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / torch.tensor(math.sqrt(hd), dtype=dt)
        causal = torch.ones((l, l), dtype=torch.bool, device=x.device).tril()
        mask = causal[None, None] & (attention_mask[:, None, None, :] > 0)
        scores = torch.where(mask, scores, torch.tensor(-1e9, dtype=scores.dtype, device=x.device))
        probs = dropout(softmax(scores), c.dropout, self.training, rng)
        ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, l, d)
        x = x + dropout(self.attn.c_proj(ctx, dt), c.dropout, self.training, rng)
        h = flax_layer_norm(x, self.ln_2, dt)
        h = self.mlp.c_proj(gelu_new(self.mlp.c_fc(h, dt)), dt)
        return x + dropout(h, c.dropout, self.training, rng)


class _GPT2Model(nn.Module):
    def __init__(self, c: GPT2Config, dtype):
        super().__init__()
        self.wte = nn.Embedding(c.vocab_size, c.hidden_size)
        self.wpe = nn.Embedding(c.max_positions, c.hidden_size)
        self.h = nn.ModuleList([GPT2Block(c, dtype) for _ in range(c.num_layers)])
        self.ln_f = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)


class GPT2Encoder(nn.Module):
    """input_ids/attention_mask [B, L] -> the final LayerNorm's hidden
    states [B, L, H] (``transformer.*``)."""

    def __init__(self, c: GPT2Config, dtype=torch.float32):
        super().__init__()
        self.cfg, self.dtype = c, dtype
        self.transformer = _GPT2Model(c, dtype)

    @property
    def hidden_size(self) -> int:
        return self.cfg.hidden_size

    def forward(self, input_ids, attention_mask, rng=None):
        t, dt = self.transformer, self.dtype
        l = input_ids.shape[1]
        h = F.embedding(input_ids, t.wte.weight).to(dt) + t.wpe.weight[:l][None].to(dt)
        h = dropout(h, self.cfg.dropout, self.training, rng)
        for block in t.h:
            h = block(h, attention_mask, rng)
        return flax_layer_norm(h, t.ln_f, dt)


# ----------------------------------------------------------------------- T5


@dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    hidden_size: int = 512
    num_layers: int = 6
    num_heads: int = 8
    head_dim: int = 64
    ff_dim: int = 2048
    gated_ff: bool = False  # flan-t5 uses gated gelu; t5 v1.0 plain relu
    relative_buckets: int = 32
    relative_max_distance: int = 128
    layer_norm_eps: float = 1e-6
    dropout: float = 0.1


class RMSNorm(nn.Module):
    """T5's LayerNorm: x * rsqrt(mean(x^2) + eps) (statistics in f32), cast
    back to x's dtype, times the f32 ``weight``: the product is promoted to
    f32 for a bf16 ``x``, as in JAX."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.eps = eps

    def forward(self, x):
        var = x.float().square().mean(-1, keepdim=True)
        return (x * torch.rsqrt(var + self.eps)).to(x.dtype) * self.weight


def t5_relative_bucket(relative_position, num_buckets: int = 32, max_distance: int = 128):
    """Bidirectional bucketing (T5 encoder) of an integer tensor, JAX's f32
    arithmetic step by step: the log of a large distance in f32, truncated
    to int32."""
    num_buckets //= 2
    ret = (relative_position > 0).to(torch.int32) * num_buckets
    n = relative_position.abs()
    max_exact = num_buckets // 2
    is_small = n < max_exact
    log_ratio = torch.log(torch.tensor(max_distance / max_exact, dtype=torch.float32))
    val_if_large = max_exact + (
        torch.log(n.to(torch.float32) / max_exact + 1e-6) / log_ratio * (num_buckets - max_exact)
    ).to(torch.int32)
    val_if_large = torch.clamp(val_if_large, max=num_buckets - 1)
    return ret + torch.where(is_small, n.to(torch.int32), val_if_large)


class _T5SelfAttention(nn.Module):
    def __init__(self, c: T5Config, has_relative_bias: bool):
        super().__init__()
        inner = c.num_heads * c.head_dim
        self.q = nn.Linear(c.hidden_size, inner, bias=False)
        self.k = nn.Linear(c.hidden_size, inner, bias=False)
        self.v = nn.Linear(c.hidden_size, inner, bias=False)
        self.o = nn.Linear(inner, c.hidden_size, bias=False)
        if has_relative_bias:
            self.relative_attention_bias = nn.Embedding(c.relative_buckets, c.num_heads)


class _T5LayerSelfAttention(nn.Module):
    def __init__(self, c: T5Config, has_relative_bias: bool):
        super().__init__()
        self.SelfAttention = _T5SelfAttention(c, has_relative_bias)
        self.layer_norm = RMSNorm(c.hidden_size, c.layer_norm_eps)


class _T5DenseReluDense(nn.Module):
    def __init__(self, c: T5Config):
        super().__init__()
        if c.gated_ff:
            self.wi_0 = nn.Linear(c.hidden_size, c.ff_dim, bias=False)
            self.wi_1 = nn.Linear(c.hidden_size, c.ff_dim, bias=False)
        else:
            self.wi = nn.Linear(c.hidden_size, c.ff_dim, bias=False)
        self.wo = nn.Linear(c.ff_dim, c.hidden_size, bias=False)


class _T5LayerFF(nn.Module):
    def __init__(self, c: T5Config):
        super().__init__()
        self.DenseReluDense = _T5DenseReluDense(c)
        self.layer_norm = RMSNorm(c.hidden_size, c.layer_norm_eps)


# (device, L, buckets, max distance) -> the [L, L] bucket table, computed on
# the CPU once so that every device indexes the same buckets.
_BUCKETS: dict = {}


def relative_buckets(l: int, num_buckets: int, max_distance: int, device):
    key = (str(device), l, num_buckets, max_distance)
    if key not in _BUCKETS:
        rel = torch.arange(l)[None, :] - torch.arange(l)[:, None]  # memory - query
        _BUCKETS[key] = t5_relative_bucket(rel, num_buckets, max_distance).long().to(device)
    return _BUCKETS[key]


class T5Block(nn.Module):
    """Self-attention (no 1/sqrt(d); block 0 computes the position bias,
    later blocks take it) and the ReLU or gated-GELU feed-forward, each
    behind an RMSNorm."""

    def __init__(self, c: T5Config, has_relative_bias: bool, dtype=torch.float32):
        super().__init__()
        self.cfg, self.dtype = c, dtype
        self.layer = nn.ModuleList([_T5LayerSelfAttention(c, has_relative_bias), _T5LayerFF(c)])

    def forward(self, x, attention_mask, position_bias=None, rng=None):
        c, dt = self.cfg, self.dtype
        b, l, _ = x.shape
        sa, ff = self.layer[0], self.layer[1].DenseReluDense
        att = sa.SelfAttention
        h = sa.layer_norm(x)

        def proj(mod):
            return linear(h, mod, dt).reshape(b, l, c.num_heads, c.head_dim)

        q, k, v = proj(att.q), proj(att.k), proj(att.v)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k)
        if position_bias is None:
            buckets = relative_buckets(l, c.relative_buckets, c.relative_max_distance, x.device)
            table = att.relative_attention_bias.weight
            position_bias = table[buckets].permute(2, 0, 1)[None].to(scores.dtype)
        scores = scores + position_bias
        scores = torch.where(attention_mask[:, None, None, :] > 0, scores,
                             torch.tensor(-1e9, dtype=scores.dtype, device=x.device))
        probs = dropout(softmax(scores), c.dropout, self.training, rng)
        ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, l, c.num_heads * c.head_dim)
        x = x + dropout(linear(ctx, att.o, dt), c.dropout, self.training, rng)
        h = self.layer[1].layer_norm(x)
        if c.gated_ff:
            h = gelu_tanh(linear(h, ff.wi_0, dt)) * linear(h, ff.wi_1, dt)
        else:
            h = F.relu(linear(h, ff.wi, dt))
        h = linear(dropout(h, c.dropout, self.training, rng), ff.wo, dt)
        return x + dropout(h, c.dropout, self.training, rng), position_bias


class _T5Stack(nn.Module):
    def __init__(self, c: T5Config, dtype):
        super().__init__()
        self.block = nn.ModuleList([T5Block(c, i == 0, dtype) for i in range(c.num_layers)])
        self.final_layer_norm = RMSNorm(c.hidden_size, c.layer_norm_eps)


class T5Encoder(nn.Module):
    """input_ids/attention_mask [B, L] -> the final RMSNorm's hidden states
    [B, L, H] (f32 under bf16 compute, as JAX's), after dropout."""

    def __init__(self, c: T5Config, dtype=torch.float32):
        super().__init__()
        self.cfg, self.dtype = c, dtype
        self.shared = nn.Embedding(c.vocab_size, c.hidden_size)
        self.encoder = _T5Stack(c, dtype)

    @property
    def hidden_size(self) -> int:
        return self.cfg.hidden_size

    def forward(self, input_ids, attention_mask, rng=None):
        c = self.cfg
        h = dropout(F.embedding(input_ids, self.shared.weight).to(self.dtype), c.dropout,
                    self.training, rng)
        bias = None
        for block in self.encoder.block:
            h, bias = block(h, attention_mask, bias, rng)
        return dropout(self.encoder.final_layer_norm(h), c.dropout, self.training, rng)


# ------------------------------------------------------- pooled narration API


class PooledLMEncoder(nn.Module):
    """GPT2Layer / T5WikiLayer: ``encoder`` (a :class:`GPT2Encoder` or
    :class:`T5Encoder`) -> tokens ("tokens") or their masked mean,
    L2-normalised ("embedding") -> ``out_mlp`` where its width differs from
    the tower's -> tanh if ``out_tanh`` -> dropout. Returns (features,
    attention_mask)."""

    def __init__(self, encoder: nn.Module, out_mode: str = "tokens", out_mlp: int | None = None,
                 out_tanh: bool = False, out_dropout: float = 0.1, dtype=torch.float32):
        super().__init__()
        self.encoder = encoder
        self.out_mode, self.out_tanh, self.out_dropout, self.dtype = out_mode, out_tanh, out_dropout, dtype
        hidden = encoder.hidden_size
        self.out_mlp = nn.Linear(hidden, out_mlp) if out_mlp and out_mlp != hidden else None

    def forward(self, input_ids, attention_mask, rng=None):
        out = self.encoder(input_ids, attention_mask, rng)
        if self.out_mode == "embedding":
            out = mean_pool(out, attention_mask)
            out = out / torch.clamp(torch.linalg.vector_norm(out, dim=-1, keepdim=True), min=1e-12)
        if self.out_mlp is not None:
            out = linear(out, self.out_mlp, self.dtype)
        if self.out_tanh:
            out = torch.tanh(out)
        return dropout(out, self.out_dropout, self.training, rng), attention_mask


def t5_config(model_v: str) -> T5Config:
    """The four T5 geometries the narration configs name (the reference's
    t5_urls): t5-small / t5-large, the v1.0 ReLU towers; flan-t5-small /
    flan-t5-large, the gated-GELU v1.1 geometry."""
    return {
        "t5-small": T5Config(),
        "t5-large": T5Config(hidden_size=1024, num_layers=24, num_heads=16, ff_dim=4096),
        "flan-t5-small": T5Config(hidden_size=512, num_layers=8, num_heads=6, ff_dim=1024,
                                  gated_ff=True),
        "flan-t5-large": T5Config(hidden_size=1024, num_layers=24, num_heads=16, ff_dim=2816,
                                  gated_ff=True),
    }[model_v]
