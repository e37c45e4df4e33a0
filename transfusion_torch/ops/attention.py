"""Self-attention forward in the projections' [B, N, H, D] layout: kernel K2
and its plain version.

Port of ``transfusion_tpu/ops/attention.py::flash_attention_train`` at
dropout rate 0 (the eval path; Pallas ``_fwd_kernel`` at :226). Semantics:
``softmax(q k^T / sqrt(D) + bias) v`` with an additive -1e30 bias on padded
keys and an f32 scale, products in the input dtype with f32 accumulation,
the probabilities rounded to the input dtype for the P.V product, and the
row sum divided out after it. The per-row f32 statistics (m, l) come back in
``[B, H, N, 2]`` when asked for.

On a CUDA tensor :func:`attention_fwd` launches ``csrc/attention.cu``; on a
CPU tensor it runs :func:`attention_plain`.
"""

from __future__ import annotations

import torch

from transfusion_torch import kernels

NEG = -1e30
# Head dims the bf16 kernel is compiled for (csrc/attention.cu): the flagship's
# 896 / 4 heads. The f32 kernel takes any D <= 256.
BF16_HEAD_DIMS = (224,)


def key_bias(key_padding_mask, bsz: int, n: int, device):
    """[B, N] f32 additive bias: -1e30 where the key is padding (True)."""
    if key_padding_mask is None:
        return torch.zeros((bsz, n), dtype=torch.float32, device=device)
    return torch.where(key_padding_mask.to(device=device, dtype=torch.bool),
                       NEG, 0.0).to(torch.float32)


def attention_plain(q, k, v, key_padding_mask=None):
    """Plain PyTorch statement of the kernel: returns (out, stats)."""
    b, n, h, d = q.shape
    scale = 1.0 / (d ** 0.5)
    bias = key_bias(key_padding_mask, b, n, q.device)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale + bias[:, None, None, :]
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    out = (o / l.permute(0, 2, 1, 3)).to(q.dtype)
    return out, torch.cat([m, l], -1)


def _attention_cuda(q, k, v, key_padding_mask):
    b, n, h, d = q.shape
    for t in (q, k, v):
        kernels.require(t.shape == q.shape and t.dtype == q.dtype and t.device == q.device,
                        "attention: q, k, v must match")
        kernels.require(t.is_contiguous(), "attention: q, k, v must be contiguous [B, N, H, D]")
        kernels.require(t.data_ptr() % 16 == 0, "attention: inputs must be 16-byte aligned")
    kernels.require(q.dtype in (torch.bfloat16, torch.float32), f"attention: dtype {q.dtype}")
    kernels.require(d <= 256, "attention: head dim must be <= 256")
    kernels.require(q.dtype != torch.bfloat16 or d in BF16_HEAD_DIMS,
                    f"attention: bf16 head dim must be one of {BF16_HEAD_DIMS}")
    bias = key_bias(key_padding_mask, b, n, q.device).contiguous()
    out = torch.empty_like(q)
    stats = torch.empty((b, h, n, 2), dtype=torch.float32, device=q.device)
    code = kernels.library().tf_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(),
        stats.data_ptr(), b, n, h, d, float(1.0 / (d ** 0.5)),
        int(q.dtype == torch.bfloat16), kernels.stream_handle(q.device),
    )
    kernels.check(code, "tf_attention_fwd")
    kernels.LAUNCHES["attention_fwd"] += 1
    return out, stats


def attention_fwd(q, k, v, key_padding_mask=None, dropout_rate: float = 0.0,
                  return_stats: bool = False):
    """q/k/v [B, N, H, D]; key_padding_mask [B, N] bool, True = ignore.
    Returns [B, N, H, D] (and the [B, H, N, 2] f32 (m, l) statistics)."""
    if dropout_rate > 0.0:
        raise NotImplementedError("attention dropout is not ported yet (eval uses rate 0)")
    if q.device.type == "cpu":
        out, stats = attention_plain(q, k, v, key_padding_mask)
    else:
        out, stats = _attention_cuda(q, k, v, key_padding_mask)
    return (out, stats) if return_stats else out
