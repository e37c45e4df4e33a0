"""BERT/MiniLM encoder and the narration pooling layer (port of
``transfusion_tpu/models/text_encoder.py``, eval, tokens mode).

Parameter names follow huggingface ``BertModel`` under the reference's
``narr_pooling_layer.encoder.0.auto_model`` prefix, so the state dict is the
reference checkpoint's. LayerNorms here are plain PyTorch with flax
semantics (f32 statistics, var = E[x^2] - mean^2, eps 1e-12), as the JAX
model leaves them to XLA.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from transfusion_torch.ops.layer_norm import layer_norm_plain


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 384
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 1536
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12

    @classmethod
    def minilm_l12(cls) -> "BertConfig":
        return cls()


def linear(x, mod: nn.Linear, dtype):
    """A linear layer in the compute dtype with f32 parameters cast at use."""
    b = None if mod.bias is None else mod.bias.to(dtype)
    return F.linear(x.to(dtype), mod.weight.to(dtype), b)


def flax_layer_norm(x, mod: nn.LayerNorm, dtype):
    """flax ``nn.LayerNorm(dtype=dtype)``: f32 statistics with the fast
    variance (the plain version of kernel K1's arithmetic), f32 affine,
    output in ``dtype``."""
    return layer_norm_plain(x, mod.weight, mod.bias, mod.eps).to(dtype)


class _Embeddings(nn.Module):
    def __init__(self, c: BertConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(c.vocab_size, c.hidden_size)
        self.position_embeddings = nn.Embedding(c.max_position_embeddings, c.hidden_size)
        self.token_type_embeddings = nn.Embedding(c.type_vocab_size, c.hidden_size)
        self.LayerNorm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)


class _SelfAttention(nn.Module):
    def __init__(self, c: BertConfig):
        super().__init__()
        self.query = nn.Linear(c.hidden_size, c.hidden_size)
        self.key = nn.Linear(c.hidden_size, c.hidden_size)
        self.value = nn.Linear(c.hidden_size, c.hidden_size)


class _Dense(nn.Module):
    def __init__(self, cin: int, cout: int, eps: float | None = None):
        super().__init__()
        self.dense = nn.Linear(cin, cout)
        if eps is not None:
            self.LayerNorm = nn.LayerNorm(cout, eps=eps)


class _Attention(nn.Module):
    def __init__(self, c: BertConfig):
        super().__init__()
        self.self = _SelfAttention(c)
        self.output = _Dense(c.hidden_size, c.hidden_size, c.layer_norm_eps)


class BertLayer(nn.Module):
    def __init__(self, c: BertConfig, dtype):
        super().__init__()
        self.cfg, self.dtype = c, dtype
        self.attention = _Attention(c)
        self.intermediate = _Dense(c.hidden_size, c.intermediate_size)
        self.output = _Dense(c.intermediate_size, c.hidden_size, c.layer_norm_eps)

    def forward(self, h, mask):
        c, dt = self.cfg, self.dtype
        b, l, _ = h.shape
        hd = c.hidden_size // c.num_heads
        sa = self.attention.self

        def heads(mod):
            return linear(h, mod, dt).reshape(b, l, c.num_heads, hd)

        q, k, v = heads(sa.query), heads(sa.key), heads(sa.value)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / torch.tensor(hd ** 0.5, dtype=dt)
        scores = torch.where(mask[:, None, None, :] > 0, scores,
                             torch.tensor(-1e9, dtype=scores.dtype, device=scores.device))
        probs = torch.softmax(scores, dim=-1)
        ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, l, c.hidden_size)
        attn = linear(ctx, self.attention.output.dense, dt)
        h = flax_layer_norm(h + attn, self.attention.output.LayerNorm, dt)
        inter = F.gelu(linear(h, self.intermediate.dense, dt))
        out = linear(inter, self.output.dense, dt)
        return flax_layer_norm(h + out, self.output.LayerNorm, dt)


class _Encoder(nn.Module):
    def __init__(self, c: BertConfig, dtype):
        super().__init__()
        self.layer = nn.ModuleList([BertLayer(c, dtype) for _ in range(c.num_layers)])


class BertEncoder(nn.Module):
    """input_ids/attention_mask [B, L] -> per-token hidden states [B, L, H]."""

    def __init__(self, c: BertConfig, dtype=torch.float32):
        super().__init__()
        self.cfg, self.dtype = c, dtype
        self.embeddings = _Embeddings(c)
        self.encoder = _Encoder(c, dtype)

    def forward(self, input_ids, attention_mask):
        e = self.embeddings
        l = input_ids.shape[1]
        word = e.word_embeddings.weight.to(self.dtype)[input_ids]
        h = word + e.position_embeddings.weight[:l][None] + e.token_type_embeddings.weight[0][None, None]
        h = flax_layer_norm(h, e.LayerNorm, self.dtype)
        for layer in self.encoder.layer:
            h = layer(h, attention_mask)
        return h


def mean_pool(token_embeddings, attention_mask):
    """sentence-transformers mean pooling with mask."""
    m = attention_mask[..., None].to(token_embeddings.dtype)
    summed = (token_embeddings * m).sum(1)
    return summed / torch.clamp(m.sum(1), min=1e-9)


class _SentenceTransformer(nn.Module):
    def __init__(self, c: BertConfig, dtype):
        super().__init__()
        self.auto_model = BertEncoder(c, dtype)


class NarrationEncoder(nn.Module):
    """SBertLayer in tokens mode: BERT tokens -> out_mlp. Returns (tokens,
    attention_mask). Keys: ``encoder.0.auto_model.*`` and ``out_mlp``."""

    def __init__(self, c: BertConfig, out_mlp: int | None = 896, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.encoder = nn.ModuleList([_SentenceTransformer(c, dtype)])
        self.out_mlp = (
            nn.Linear(c.hidden_size, out_mlp) if out_mlp and out_mlp != c.hidden_size else None
        )

    def forward(self, input_ids, attention_mask):
        tokens = self.encoder[0].auto_model(input_ids, attention_mask)
        if self.out_mlp is not None:
            tokens = linear(tokens, self.out_mlp, self.dtype)
        return tokens, attention_mask
