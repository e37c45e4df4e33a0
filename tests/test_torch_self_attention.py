"""Parity of the port's exact self-attention (K7:
``transfusion_torch.ops.attention.flash_self_attention`` and
``flash_self_attention_blhd``) with the JAX package's, on the CPU where the
port runs its plain version. The JAX side runs as tests/test_flash_attention.py
runs it: the Pallas kernel in interpret mode with ``block_q=32``, and the XLA
reference ``xla_self_attention``. Inputs are made with numpy from a seed and
handed to both.

Tolerances: f32 2e-5 (the JAX package's own flash-vs-XLA bound); the two
layouts 1e-5 (tests/test_flash_attention.py's bound for the same check);
bf16 1e-2, one bf16 ulp of an O(1) output.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transfusion_torch.ops import attention as t_attn
from transfusion_tpu.ops import attention as j_attn


def _inputs(rng, b=2, n=70, h=2, d=24, masked=True):
    """[B, N, H, D] q/k/v and a key-padding mask with a padded tail on one row."""
    q, k, v = (rng.normal(0, 1, (b, n, h, d)).astype(np.float32) for _ in range(3))
    mask = np.zeros((b, n), bool)
    if masked:
        mask[0, n - 9:] = True
    return q, k, v, mask


def _t(x, dtype=None):
    out = torch.from_numpy(np.ascontiguousarray(x))
    return out if dtype is None else out.to(dtype)


def _bhnd(x):
    return np.ascontiguousarray(x.transpose(0, 2, 1, 3))


@pytest.mark.parametrize("masked", [True, False])
def test_blhd_matches_jax_flash_and_xla(masked):
    """[B, N, H, D], D = 24 (not a power of two), N = 70 (not a multiple of
    the TPU kernel's 32-row block); with a padded key tail on one row, and
    with no mask at all."""
    q, k, v, mask = _inputs(np.random.default_rng(1), masked=masked)
    jmask = jnp.asarray(mask) if masked else None
    got = t_attn.flash_self_attention_blhd(_t(q), _t(k), _t(v), _t(mask) if masked else None)
    ref = j_attn.flash_self_attention_blhd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jmask,
                                           block_q=32)
    xla = j_attn.xla_self_attention(*(jnp.asarray(_bhnd(x)) for x in (q, k, v)), jmask)
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(xla).transpose(0, 2, 1, 3), rtol=2e-5,
                               atol=2e-5)


def test_bhnd_matches_jax_flash_and_xla():
    """[B, H, N, D] in and out, the same case as the [B, N, H, D] test."""
    q, k, v, mask = _inputs(np.random.default_rng(2))
    q, k, v = (_bhnd(x) for x in (q, k, v))
    got = t_attn.flash_self_attention(_t(q), _t(k), _t(v), _t(mask))
    ref = j_attn.flash_self_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      jnp.asarray(mask), block_q=32)
    xla = j_attn.xla_self_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask))
    assert got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(xla), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(t_attn.self_attention_plain(_t(q), _t(k), _t(v), _t(mask)).numpy(),
                               got.numpy(), rtol=0, atol=0)


def test_bhnd_and_blhd_agree():
    """The two layouts give the same result (D 16, N 40), as
    tests/test_flash_attention.py::test_bhnd_and_blhd_agree holds JAX's."""
    q, k, v, mask = _inputs(np.random.default_rng(3), n=40, d=16)
    a = t_attn.flash_self_attention(*(_t(_bhnd(x)) for x in (q, k, v)), _t(mask))
    b = t_attn.flash_self_attention_blhd(_t(q), _t(k), _t(v), _t(mask))
    np.testing.assert_allclose(a.transpose(1, 2).numpy(), b.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("layout", ["bhnd", "blhd"])
def test_bf16_matches_jax_flash(layout):
    """bf16 inputs: scores in f32, P rounded to bf16 for P.V, the output in
    bf16: one bf16 ulp of an O(1) output (1e-2)."""
    q, k, v, mask = _inputs(np.random.default_rng(4), n=40, d=16)
    if layout == "bhnd":
        q, k, v = (_bhnd(x) for x in (q, k, v))
    jfn = j_attn.flash_self_attention if layout == "bhnd" else j_attn.flash_self_attention_blhd
    tfn = t_attn.flash_self_attention if layout == "bhnd" else t_attn.flash_self_attention_blhd
    got = tfn(*(_t(x, torch.bfloat16) for x in (q, k, v)), _t(mask))
    ref = jfn(*(jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)), jnp.asarray(mask),
              block_q=32)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), rtol=1e-2, atol=1e-2)
