"""BERT/MiniLM encoder and the narration pooling layer (port of
``transfusion_tpu/models/text_encoder.py``, tokens and embedding modes,
``out_tanh`` and the inline type embeddings). Training mode
turns on the JAX modules' dropout sites (embeddings, attention
probabilities, attention and feed-forward outputs, after ``out_mlp``).

Parameter names follow huggingface ``BertModel`` under the reference's
``narr_pooling_layer.encoder.0.auto_model`` prefix, so the state dict is the
reference checkpoint's. The LayerNorms have flax semantics (f32
statistics, var = E[x^2] - mean^2, eps 1e-12), which is kernel K1's
arithmetic: they run K1 through :func:`layer_norm` (the residual post-norms
with their add folded in; a closed-form backward in training). The JAX
model leaves them to XLA.

Dropout draws from a :class:`DropoutRNG`, the explicit generators of one
train step derived from (seed, step), which the step passes down as ``rng``;
eval makes no draw.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from transfusion_torch.ops.layer_norm import layer_norm
from transfusion_torch.parallel import tensor_parallel as tp
from transfusion_torch.parallel.mesh import model_rank


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
    dropout: float = 0.1

    @classmethod
    def minilm_l12(cls) -> "BertConfig":
        return cls()

    @classmethod
    def minilm_l6(cls) -> "BertConfig":
        return cls(num_layers=6)


def linear(x, mod: nn.Linear, dtype):
    """A linear layer in the compute dtype with f32 parameters cast at use.
    A row-parallel layer (``mod.tp`` "row": its input split over the model
    axis; "split": its input replicated, so the rank takes its columns)
    sums its partial products over the model group, then adds the bias."""
    b = None if mod.bias is None else mod.bias.to(dtype)
    kind = getattr(mod, "tp", None)
    if kind is None:
        return F.linear(x.to(dtype), mod.weight.to(dtype), b)
    x = tp.split_to_model(x.to(dtype)) if kind == "split" else x.to(dtype)
    y = tp.reduce_from_model(F.linear(x, mod.weight.to(dtype)))
    return y if b is None else y + b


def model_shard(dim: int, size: int):
    """(dim, rank, size): a tensor split along ``dim`` over a model axis of
    ``size`` (None at size 1), for :meth:`DropoutRNG.keep`."""
    return None if size == 1 else (dim, model_rank(), size)


# Offsets that keep DropoutRNG's streams apart from each other and from the
# samplers' generator (train.step.step_generator seeds it with seed * 1_000_003
# + step).
_MASK_STREAM, _SEED_STREAM = 1 << 48, 2 << 48


class DropoutRNG:
    """The dropout randomness of one train step, a function of (seed, step)
    alone, so that the step replays: keep masks from a generator on the
    model's device, and kernel K2's int32 seeds from a CPU generator (drawn
    without a device synchronisation).

    ``rows`` (start, stop, total) places the step's batch in a
    data-parallel global batch of ``total`` images: a keep mask is then
    drawn for the global tensor and this rank keeps its rows, and the
    attention kernels hash the global image index (``batch_offset``), so
    each image gets the draws of the one-rank run. The masked tensors'
    leading dimension runs over the images first (image-major)."""

    def __init__(self, device, seed: int, step: int, rows=None):
        base = seed * 1_000_003 + step
        self.masks = torch.Generator(device=device).manual_seed(base + _MASK_STREAM)
        self.seeds = torch.Generator().manual_seed(base + _SEED_STREAM)
        self.rows = None if rows is None or rows[1] - rows[0] == rows[2] else tuple(rows)

    def fork(self) -> "DropoutRNG":
        """A copy that stands where this one stands: it makes the draws this
        one would make next (keep masks and K2 seeds), and neither advances
        the other. A rematerialised fusion level replays its span of draws
        from a fork taken before the level ran."""
        twin = DropoutRNG.__new__(DropoutRNG)
        twin.masks = torch.Generator(device=self.masks.device)
        twin.masks.set_state(self.masks.get_state())
        twin.seeds = torch.Generator()
        twin.seeds.set_state(self.seeds.get_state())
        twin.rows = self.rows
        return twin

    @property
    def batch_offset(self) -> int:
        return 0 if self.rows is None else self.rows[0]

    def attention_seed(self) -> int:
        return int(torch.randint(-2 ** 31, 2 ** 31, (), generator=self.seeds))

    def keep(self, x, rate: float, shard=None):
        """flax ``nn.Dropout`` of ``x``: keep with probability 1 - rate, scaled
        by 1 / (1 - rate), in PyTorch's fused dropout kernel. That kernel takes
        no generator, so the mask generator's state is swapped into the
        device's default generator for the one draw and back out after it:
        the draw advances the mask generator, and the default generator ends
        as it began. (A mask drawn apart and applied by torch.where cost the
        flagship train step about 8 ms of device time on the card.) Under
        ``rows``, or for ``x`` split over the model axis (``shard`` (dim,
        rank, size) from :func:`model_shard`), the mask is drawn apart for
        the global tensor in x's dtype, as PyTorch draws it for that shape,
        and x takes its part: on CUDA the fused kernel's keep mask of a
        tensor of ones (its random stream depends on the dtype's vector
        width), applied as the kernel applies it (x times the f32 scale
        1 / (1 - rate), rounded once); on the CPU the Bernoulli noise of
        ``F.dropout``."""
        default = (torch.cuda.default_generators[x.device.index if x.device.index is not None
                                                 else torch.cuda.current_device()]
                   if x.device.type == "cuda" else torch.default_generator)
        before = default.get_state()
        default.set_state(self.masks.get_state())
        try:
            if self.rows is None and shard is None:
                return F.dropout(x, rate, True)
            return self._keep_part(x, rate, shard)
        finally:
            self.masks.set_state(default.get_state())
            default.set_state(before)

    def _keep_part(self, x, rate: float, shard):
        shape, cut = list(x.shape), [slice(None)] * x.ndim
        if self.rows is not None:
            start, stop, total = self.rows
            per, rem = divmod(x.shape[0], stop - start)
            if rem:
                raise ValueError(f"a dropout input of {x.shape[0]} rows is not image-major over "
                                 f"{stop - start} images")
            shape[0], cut[0] = total * per, slice(start * per, stop * per)
        if shard is not None:
            dim, index, size = shard
            dim %= x.ndim
            n = x.shape[dim]
            shape[dim], cut[dim] = n * size, slice(index * n, (index + 1) * n)
        cut = tuple(cut)
        if x.device.type == "cuda":
            keep = torch.native_dropout(torch.ones(shape, dtype=x.dtype, device=x.device), rate,
                                        True)[1]
            scale = float(np.float32(1.0 / float(np.float32(1.0 - rate))))
            return (x.float() * (keep[cut] * scale)).to(x.dtype)
        noise = torch.empty(shape, dtype=x.dtype).bernoulli_(1 - rate).div_(1 - rate)
        return x * noise[cut]


def need_rng(rng):
    if rng is None:
        raise ValueError("dropout in training mode draws from the step's DropoutRNG: pass rng")
    return rng


def dropout(x, rate: float, training: bool, rng: DropoutRNG | None, shard=None):
    """flax ``nn.Dropout`` in training at a rate above 0 (drawn from
    ``rng``; ``shard`` as :meth:`DropoutRNG.keep`); the identity otherwise."""
    return need_rng(rng).keep(x, rate, shard) if training and rate > 0.0 else x


def flax_layer_norm(x, mod: nn.LayerNorm, dtype, residual=None):
    """flax ``nn.LayerNorm(dtype=dtype)`` of ``x`` (or of ``x + residual``,
    both cast to ``dtype`` and summed in it): f32 statistics with the fast
    variance, f32 affine, output in ``dtype``: kernel K1 with
    :func:`layer_norm`'s backward."""
    if residual is not None:
        x, residual = x.to(dtype), residual.to(dtype)
    return layer_norm(x, mod.weight, mod.bias, mod.eps, residual).to(dtype)


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
    """Under a model axis (``parallel.tensor_parallel``) the attention runs
    on the rank's heads and the feed-forward on its hidden columns
    (``attn_tp`` / ``mlp_tp`` ranks)."""

    def __init__(self, c: BertConfig, dtype):
        super().__init__()
        self.cfg, self.dtype = c, dtype
        self.attention = _Attention(c)
        self.intermediate = _Dense(c.hidden_size, c.intermediate_size)
        self.output = _Dense(c.intermediate_size, c.hidden_size, c.layer_norm_eps)
        self.attn_tp = self.mlp_tp = 1

    def forward(self, h, mask, rng=None):
        c, dt = self.cfg, self.dtype
        b, l, _ = h.shape
        hd = c.hidden_size // c.num_heads
        heads = c.num_heads // self.attn_tp
        sa = self.attention.self
        hq = tp.copy_to_model(h, self.attn_tp)

        def heads_of(mod):
            return linear(hq, mod, dt).reshape(b, l, heads, hd)

        q, k, v = heads_of(sa.query), heads_of(sa.key), heads_of(sa.value)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / torch.tensor(hd ** 0.5, dtype=dt)
        scores = torch.where(mask[:, None, None, :] > 0, scores,
                             torch.tensor(-1e9, dtype=scores.dtype, device=scores.device))
        probs = dropout(torch.softmax(scores, dim=-1), c.dropout, self.training, rng,
                        model_shard(1, self.attn_tp))
        ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, l, heads * hd)
        attn = dropout(linear(ctx, self.attention.output.dense, dt), c.dropout, self.training, rng)
        h = flax_layer_norm(h, self.attention.output.LayerNorm, dt, residual=attn)
        inter = F.gelu(linear(tp.copy_to_model(h, self.mlp_tp), self.intermediate.dense, dt))
        out = dropout(linear(inter, self.output.dense, dt), c.dropout, self.training, rng)
        return flax_layer_norm(h, self.output.LayerNorm, dt, residual=out)


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

    def forward(self, input_ids, attention_mask, rng=None):
        e = self.embeddings
        l = input_ids.shape[1]
        word = e.word_embeddings.weight.to(self.dtype)[input_ids]
        h = word + e.position_embeddings.weight[:l][None] + e.token_type_embeddings.weight[0][None, None]
        h = dropout(flax_layer_norm(h, e.LayerNorm, self.dtype), self.cfg.dropout, self.training, rng)
        for layer in self.encoder.layer:
            h = layer(h, attention_mask, rng)
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
    """SBertLayer: BERT tokens (``out_mode`` "tokens") or their masked mean,
    L2-normalised (norm clipped at 1e-12; "embedding") -> out_mlp -> tanh
    if ``out_tanh`` -> dropout. Returns (tokens [B, L, D] or the sentence
    vector [B, D], attention_mask). ``type_embeddings`` names learned
    per-type vectors (initialised normal(1 / type_embedding_init_div)),
    which a [B, L, T] ``type_mask`` from the tokenizer's inline
    ``word<type>`` markers adds to the marked tokens after the encoder.
    Keys: ``encoder.0.auto_model.*``, ``type_embeddings.<name>`` and
    ``out_mlp``."""

    def __init__(self, c: BertConfig, out_mlp: int | None = 896, dtype=torch.float32,
                 out_dropout: float = 0.1, out_mode: str = "tokens", out_tanh: bool = False,
                 type_embeddings: tuple = (), type_embedding_init_div: float = 1.0):
        super().__init__()
        self.dtype, self.out_dropout, self.out_mode = dtype, out_dropout, out_mode
        self.out_tanh = out_tanh
        self.type_names, self.type_embedding_init_div = tuple(type_embeddings), type_embedding_init_div
        self.encoder = nn.ModuleList([_SentenceTransformer(c, dtype)])
        if self.type_names:
            self.type_embeddings = nn.ParameterDict({
                n: nn.Parameter(torch.randn(c.hidden_size) / type_embedding_init_div)
                for n in self.type_names})
        self.out_mlp = (
            nn.Linear(c.hidden_size, out_mlp) if out_mlp and out_mlp != c.hidden_size else None
        )

    def forward(self, input_ids, attention_mask, rng=None, type_mask=None):
        out = self.encoder[0].auto_model(input_ids, attention_mask, rng)
        if self.type_names and type_mask is not None:
            table = torch.stack([self.type_embeddings[n] for n in self.type_names])  # [T, H]
            out = out + torch.einsum("blt,th->blh", type_mask.to(device=out.device, dtype=out.dtype),
                                     table.to(out.dtype))
        if self.out_mode == "embedding":
            out = mean_pool(out, attention_mask)
            out = out / torch.clamp(torch.linalg.vector_norm(out, dim=-1, keepdim=True), min=1e-12)
        if self.out_mlp is not None:
            out = linear(out, self.out_mlp, self.dtype)
        if self.out_tanh:
            out = torch.tanh(out)
        return dropout(out, self.out_dropout, self.training, rng), attention_mask
