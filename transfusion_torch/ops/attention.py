"""Self-attention in the projections' [B, N, H, D] layout with probability
dropout: kernel K2 (forward), kernels K3/K4 (backward) and their plain
versions; and K7, exact self-attention without dropout in either layout.

Port of ``transfusion_tpu/ops/attention.py::flash_attention_train`` (Pallas
``_fwd_kernel`` at :226, ``_bwd_dq_kernel`` at :253, ``_bwd_dkv_kernel`` at
:297). Forward: ``softmax(q k^T / sqrt(D) + bias) v`` with an additive -1e30
bias on padded keys and an f32 scale, products in the input dtype with f32
accumulation; under dropout each probability is kept by a murmur3 hash of
its global (query, key) indices, the cell ``b * H + h`` and the seed, and
scaled by ``1 / (1 - rate)``; the probabilities are rounded to the input
dtype for the P.V product and the undropped row sum is divided out after
it. The per-row f32 statistics (m, l) come back in ``[B, H, N, 2]``.
Backward: P rebuilt from (m, l), D = rowsum(dO * O) in f32, the same keep
mask on dP, dS = P * (dP - D) rounded to the input dtype.

:func:`flash_attention_train` is the differentiable entry point (an
``autograd.Function``). On CUDA tensors its forward launches
``csrc/attention.cu`` and its backward ``csrc/attention_bwd.cu``; on CPU
tensors both run the plain versions here.

K7 (:func:`flash_self_attention` for [B, H, N, D], :func:`flash_self_attention_blhd`
for [B, N, H, D]) ports ``transfusion_tpu/ops/attention.py::flash_self_attention``
and ``::flash_self_attention_blhd`` (Pallas ``_attn_kernel`` at :29): the same
softmax without dropout, statistics or gradient. On CUDA tensors it launches
``tf_self_attention`` of ``csrc/attention.cu``, which reads either layout
through strides; on CPU tensors it runs :func:`self_attention_plain`.
"""

from __future__ import annotations

import torch

from transfusion_torch import kernels

NEG = -1e30
# Head dims the bf16 kernels are compiled for (csrc/attention.cu,
# csrc/attention_bwd.cu): the flagship's 896 / 4 heads. The f32 kernels take
# any D <= 256.
BF16_HEAD_DIMS = (224,)
_MASK32 = 0xFFFFFFFF


def key_bias(key_padding_mask, bsz: int, n: int, device):
    """[B, N] f32 additive bias: -1e30 where the key is padding (True)."""
    if key_padding_mask is None:
        return torch.zeros((bsz, n), dtype=torch.float32, device=device)
    return torch.where(key_padding_mask.to(device=device, dtype=torch.bool),
                       NEG, 0.0).to(torch.float32)


def keep_threshold(rate: float) -> int:
    """The uint32 hash threshold below which a probability is dropped, as the
    TPU kernel computes it (``jnp.uint32`` of a double: truncation)."""
    return int(min(max(rate, 0.0), 1.0) * 4294967295.0)


def _mul32(x, c: int):
    """(x * c) mod 2^32 for int64 x in [0, 2^32): in 16-bit halves of c, so
    no intermediate leaves int64."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def dropout_keep_mask(bsz: int, nh: int, n: int, seed: int, rate: float, device):
    """[B, H, N, N] bool keep mask (query rows, key columns): the plain
    statement of the hash both the TPU kernel and the CUDA kernels use."""
    r = torch.arange(n, dtype=torch.int64, device=device)
    cell = torch.arange(bsz * nh, dtype=torch.int64, device=device).reshape(bsz, nh, 1, 1)
    base = (seed & _MASK32) + _mul32(cell, 0xC2B2AE35)
    x = (_mul32(r, 0x9E3779B9)[:, None] + _mul32(r, 0x85EBCA6B)[None, :] + base) & _MASK32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x >= keep_threshold(rate)


def _scores(q, k, bias):
    d = q.shape[-1]
    scale = 1.0 / (d ** 0.5)
    return torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale + bias[:, None, None, :]


def attention_plain(q, k, v, key_padding_mask=None, dropout_rate: float = 0.0, seed: int = 0):
    """Plain PyTorch statement of K2: returns (out, stats)."""
    b, n, h, d = q.shape
    s = _scores(q, k, key_bias(key_padding_mask, b, n, q.device))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    if dropout_rate > 0.0:
        keep = dropout_keep_mask(b, h, n, seed, dropout_rate, q.device)
        p = torch.where(keep, p, 0.0) * (1.0 / (1.0 - dropout_rate))
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    out = (o / l.permute(0, 2, 1, 3)).to(q.dtype)
    return out, torch.cat([m, l], -1)


def attention_bwd_plain(q, k, v, out, stats, dout, key_padding_mask=None,
                        dropout_rate: float = 0.0, seed: int = 0):
    """Plain PyTorch statement of K3 and K4: returns (dq, dk, dv)."""
    b, n, h, d = q.shape
    dt = q.dtype
    scale = 1.0 / (d ** 0.5)
    s = _scores(q, k, key_bias(key_padding_mask, b, n, q.device))
    p = torch.exp(s - stats[..., 0:1]) / stats[..., 1:2]
    dpt = torch.einsum("bqhd,bkhd->bhqk", dout.float(), v.float())
    d_row = (dout.float() * out.float()).sum(-1).permute(0, 2, 1)[..., None]   # [B, H, N, 1]
    pt, dp = p, dpt
    if dropout_rate > 0.0:
        keep = dropout_keep_mask(b, h, n, seed, dropout_rate, q.device)
        inv = 1.0 / (1.0 - dropout_rate)
        pt = torch.where(keep, p, 0.0) * inv
        dp = torch.where(keep, dpt, 0.0) * inv
    ds = (p * (dp - d_row)).to(dt).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", pt.to(dt).float(), dout.float())
    return dq.to(dt), dk.to(dt), dv.to(dt)


def _check_inputs(name, tensors, d):
    q = tensors[0]
    for t in tensors:
        kernels.require(t.shape == q.shape and t.dtype == q.dtype and t.device == q.device,
                        f"{name}: q, k, v (and o, dout) must match")
        kernels.require(t.is_contiguous(), f"{name}: inputs must be contiguous [B, N, H, D]")
        kernels.require(t.data_ptr() % 16 == 0, f"{name}: inputs must be 16-byte aligned")
    kernels.require(q.dtype in (torch.bfloat16, torch.float32), f"{name}: dtype {q.dtype}")
    kernels.require(d <= 256, f"{name}: head dim must be <= 256")
    kernels.require(q.dtype != torch.bfloat16 or d in BF16_HEAD_DIMS,
                    f"{name}: bf16 head dim must be one of {BF16_HEAD_DIMS}")


def _dropout_args(rate: float, seed: int):
    if rate <= 0.0:
        return 0, 0, 1.0, 0
    return seed & _MASK32, keep_threshold(rate), 1.0 / (1.0 - rate), 1


def _attention_cuda(q, k, v, key_padding_mask, rate, seed):
    b, n, h, d = q.shape
    _check_inputs("attention", (q, k, v), d)
    bias = key_bias(key_padding_mask, b, n, q.device).contiguous()
    out = torch.empty_like(q)
    stats = torch.empty((b, h, n, 2), dtype=torch.float32, device=q.device)
    code = kernels.library().tf_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(),
        stats.data_ptr(), b, n, h, d, float(1.0 / (d ** 0.5)),
        int(q.dtype == torch.bfloat16), *_dropout_args(rate, seed),
        kernels.stream_handle(q.device),
    )
    kernels.check(code, "tf_attention_fwd")
    kernels.LAUNCHES["attention_fwd_dropout" if rate > 0.0 else "attention_fwd"] += 1
    return out, stats


def _attention_bwd_cuda(q, k, v, out, stats, dout, key_padding_mask, rate, seed):
    b, n, h, d = q.shape
    _check_inputs("attention backward", (q, k, v, out, dout), d)
    kernels.require(stats.shape == (b, h, n, 2) and stats.dtype == torch.float32
                    and stats.is_contiguous(), "attention backward: stats must be [B, H, N, 2] f32")
    bias = key_bias(key_padding_mask, b, n, q.device).contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    d_rows = torch.empty((b, h, n), dtype=torch.float32, device=q.device)  # D, K3 -> K4
    lib, stream = kernels.library(), kernels.stream_handle(q.device)
    common = (b, n, h, d, float(1.0 / (d ** 0.5)), int(q.dtype == torch.bfloat16),
              *_dropout_args(rate, seed), stream)
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
           bias.data_ptr(), stats.data_ptr(), d_rows.data_ptr())
    kernels.check(lib.tf_attention_bwd_dq(*ins, dq.data_ptr(), *common), "tf_attention_bwd_dq")
    kernels.LAUNCHES["attention_bwd_dq"] += 1
    kernels.check(lib.tf_attention_bwd_dkv(*ins, dk.data_ptr(), dv.data_ptr(), *common),
                  "tf_attention_bwd_dkv")
    kernels.LAUNCHES["attention_bwd_dkv"] += 1
    return dq, dk, dv


def _check_rate(rate: float):
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"attention dropout rate must be in [0, 1), got {rate}")


def attention_fwd(q, k, v, key_padding_mask=None, dropout_rate: float = 0.0, seed: int = 0,
                  return_stats: bool = False):
    """q/k/v [B, N, H, D]; key_padding_mask [B, N] bool, True = ignore; seed
    an int32 (ignored at rate 0). Returns [B, N, H, D] (and the
    [B, H, N, 2] f32 (m, l) statistics). Not differentiable: see
    :func:`flash_attention_train`."""
    _check_rate(dropout_rate)
    if q.device.type == "cpu":
        out, stats = attention_plain(q, k, v, key_padding_mask, dropout_rate, seed)
    else:
        out, stats = _attention_cuda(q, k, v, key_padding_mask, dropout_rate, seed)
    return (out, stats) if return_stats else out


def attention_bwd(q, k, v, out, stats, dout, key_padding_mask=None, dropout_rate: float = 0.0,
                  seed: int = 0):
    """Gradients (dq, dk, dv) of :func:`attention_fwd`'s output, given its
    output, statistics and the output's gradient ``dout``."""
    _check_rate(dropout_rate)
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, out, stats, dout, key_padding_mask, dropout_rate, seed)
    return _attention_bwd_cuda(q, k, v, out, stats, dout, key_padding_mask, dropout_rate, seed)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, key_padding_mask, dropout_rate, seed):
        out, stats = attention_fwd(q, k, v, key_padding_mask, dropout_rate, seed, return_stats=True)
        ctx.save_for_backward(q, k, v, out, stats)
        ctx.key_padding_mask, ctx.rate, ctx.seed = key_padding_mask, dropout_rate, seed
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, stats = ctx.saved_tensors
        dq, dk, dv = attention_bwd(q, k, v, out, stats, dout.contiguous(), ctx.key_padding_mask,
                                   ctx.rate, ctx.seed)
        return dq, dk, dv, None, None, None


def flash_attention_train(q, k, v, key_padding_mask=None, dropout_rate: float = 0.0,
                          seed: int = 0):
    """Differentiable fused attention with probability dropout (the TPU
    package's ``flash_attention_train``): q/k/v [B, N, H, D] contiguous,
    key_padding_mask [B, N] bool (True = ignore), seed an int32 varying per
    step and layer. Returns [B, N, H, D]."""
    return _FlashAttention.apply(q, k, v, key_padding_mask, float(dropout_rate), int(seed))


# ------------------------------------------------ K7: exact self-attention
def self_attention_plain(q, k, v, key_padding_mask=None):
    """Plain PyTorch statement of K7 in [B, H, N, D], the counterpart of
    ``xla_self_attention``: ``softmax(q k^T / sqrt(D) + bias) v`` with q and
    k in f32, the exact row max, P rounded to v's dtype for an f32 P.V
    product and the row sum divided out after it, as the TPU kernel does."""
    t = lambda x: x.transpose(1, 2)  # noqa: E731
    return t(attention_plain(t(q), t(k), t(v), key_padding_mask)[0])


def _self_attention_cuda(q, k, v, key_padding_mask, heads_first: bool):
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_self_attention: the K7 kernel has no backward; train through "
                           "flash_attention_train")
    if heads_first:
        b, h, n, d = q.shape
        sb, sh, sn, _ = q.stride()
    else:
        b, n, h, d = q.shape
        sb, sn, sh, _ = q.stride()
    _check_inputs("self attention", (q, k, v), d)
    bias = key_bias(key_padding_mask, b, n, q.device).contiguous()
    out = torch.empty_like(q)
    code = kernels.library().tf_self_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(), b, n, h, d,
        sb, sn, sh, float(1.0 / (d ** 0.5)), int(q.dtype == torch.bfloat16),
        kernels.stream_handle(q.device),
    )
    kernels.check(code, "tf_self_attention")
    kernels.LAUNCHES["self_attention"] += 1
    return out


def flash_self_attention(q, k, v, key_padding_mask=None):
    """Exact self-attention, q/k/v and the result [B, H, N, D];
    key_padding_mask [B, N] bool, True = ignore. On the card it has no
    gradient (the kernel has no backward) and raises under grad."""
    if q.device.type == "cpu":
        return self_attention_plain(q, k, v, key_padding_mask)
    return _self_attention_cuda(q, k, v, key_padding_mask, heads_first=True)


def flash_self_attention_blhd(q, k, v, key_padding_mask=None):
    """:func:`flash_self_attention` in the projections' [B, N, H, D] layout."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, key_padding_mask)[0]
    return _self_attention_cuda(q, k, v, key_padding_mask, heads_first=False)
