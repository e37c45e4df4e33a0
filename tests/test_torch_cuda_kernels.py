"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on the card, at small shapes that reach the edge cases the main path does
not: rows that leave a block part-empty, a head dim that is not a power of
two, a sequence that is not a multiple of the tile, RoIs hugging the packed
pyramid's edge; and the autograd round trip through the attention and
RoIAlign Functions (forward kernel, backward kernels). Needs an NVIDIA card
of compute capability 9.0 and nvcc; elsewhere every test skips. Run on the
card with

    python -m pytest tests/test_torch_cuda_kernels.py -q --noconftest

(``--noconftest``: the suite's conftest imports JAX, which the port's card
machine need not have). Tolerances: f32 kernels sum in another order than
the plain versions (1e-5, attention 2e-5); bf16 outputs may differ by one
bf16 ulp of their magnitude (attention: two ulps at max|plain|, and a mean
difference under 2^-7 of mean|plain|). The attention backward rounds dS to
bf16 from probabilities the kernel and the plain version compute with
different exp routines, so a dS may land one ulp apart: its bf16 outputs
are held at four ulps of max|plain| and the same mean bound (f32: 1e-4 of
max|plain|). RoIAlign's backward sums with atomics in a varying order: f32
1e-5 of max|plain|; bf16 one ulp of max|plain|. Dropout masks are equal bit
for bit.
"""

import math

import numpy as np
import pytest
import torch

from transfusion_torch import kernels
from transfusion_torch.ops import attention as attn
from transfusion_torch.ops import layer_norm as ln
from transfusion_torch.ops import roi_align as ra

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    if torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("the kernels are built for sm_90a")
    kernels.library()
    return torch.device("cuda")


def _on(x, dev, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    return t if dtype is None else t.to(dtype)


def _err(a, b):
    return float((a.float().cpu() - b.float().cpu()).abs().max())


def _bf16_ulp(x):
    return 2.0 ** (math.floor(math.log2(x)) - 7)


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d", [(1, 32), (77, 896), (13, 104), (9, 1000)])
def test_layer_norm_kernel_matches_plain(card, rows, d, dtype, residual):
    """Rows that leave a block part-empty; widths that leave lanes idle."""
    rng = np.random.default_rng(rows * d)
    x = _on(rng.normal(1.0, 3.0, (rows, d)).astype(np.float32), card, dtype)
    r = _on(rng.normal(0.0, 1.0, (rows, d)).astype(np.float32), card, dtype) if residual else None
    w = _on(rng.normal(1.0, 0.2, (d,)).astype(np.float32), card)
    b = _on(rng.normal(0.0, 0.2, (d,)).astype(np.float32), card)
    before = kernels.LAUNCHES["residual_layer_norm" if residual else "layer_norm"]
    got = ln.fused_layer_norm(x, w, b, residual=r)
    want = ln.layer_norm_plain(x, w, b, residual=r)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == x.shape
    assert kernels.LAUNCHES["residual_layer_norm" if residual else "layer_norm"] == before + 1
    assert _err(got, want) <= (1e-5 if dtype == torch.float32 else 3.2e-2)


@pytest.mark.parametrize("dtype,n,d", [
    (torch.float32, 70, 24),
    (torch.float32, 129, 224),
    (torch.bfloat16, 40, 224),
    (torch.bfloat16, 65, 224),
    (torch.bfloat16, 130, 224),
    (torch.bfloat16, 200, 224),
])
def test_attention_kernel_matches_plain(card, dtype, n, d):
    """Sequences that end inside a tile, a padded key tail on one row."""
    rng = np.random.default_rng(n + d)
    q, k, v = (_on(rng.normal(0, 1, (2, n, 3, d)).astype(np.float32), card, dtype) for _ in range(3))
    mask = np.zeros((2, n), bool)
    mask[0, n - 9:] = True
    mask = _on(mask, card)
    before = kernels.LAUNCHES["attention_fwd"]
    got, stats = attn.attention_fwd(q, k, v, mask, return_stats=True)
    want, stats_ref = attn.attention_plain(q, k, v, mask)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["attention_fwd"] == before + 1
    scale = float(want.float().abs().max())
    assert _err(got, want) <= (2e-5 if dtype == torch.float32 else 2 * _bf16_ulp(scale))
    mean_rel = (got.float() - want.float()).abs().mean() / want.float().abs().mean()
    assert float(mean_rel) <= 2.0 ** -7
    assert _err(stats[..., 0], stats_ref[..., 0]) <= 1e-4
    rel_l = ((stats[..., 1] - stats_ref[..., 1]).abs() / stats_ref[..., 1]).max()
    assert float(rel_l) <= (1e-5 if dtype == torch.float32 else 1e-4)


def test_attention_kernel_refuses_what_it_does_not_take(card):
    q = torch.zeros(1, 8, 1, 24, dtype=torch.bfloat16, device=card)
    with pytest.raises(ValueError, match="head dim must be one of"):
        attn.attention_fwd(q, q, q)
    with pytest.raises(ValueError, match="rate"):
        attn.attention_fwd(q.float(), q.float(), q.float(), dropout_rate=1.0)


def test_layer_norm_kernel_refuses_a_width_not_a_multiple_of_8(card):
    x, w = torch.zeros(3, 100, device=card), torch.ones(100, device=card)
    with pytest.raises(ValueError, match="multiple of 8"):
        ln.fused_layer_norm(x, w, w)


def test_layer_norm_kernel_refuses_an_input_that_needs_a_gradient(card):
    """The kernel has no backward: an input that requires grad under grad
    mode raises instead of cutting the gradient; under no_grad it runs."""
    x = torch.randn(4, 32, device=card, requires_grad=True)
    w, b = torch.ones(32, device=card), torch.zeros(32, device=card)
    with pytest.raises(RuntimeError, match="no backward"):
        ln.fused_layer_norm(x, w, b)
    with torch.no_grad():
        ln.fused_layer_norm(x, w, b)
    layer = ln.FusedLayerNorm(32).to(card).train()
    y = layer(x)
    y.sum().backward()
    assert x.grad is not None and layer.weight.grad is not None


def _attn_inputs(rng, dev, dtype, n, d, b=2, h=3):
    q, k, v = (_on(rng.normal(0, 1, (b, n, h, d)).astype(np.float32), dev, dtype) for _ in range(3))
    mask = np.zeros((b, n), bool)
    mask[0, n - 9:] = True
    return q, k, v, _on(mask, dev)


@pytest.mark.parametrize("dtype,n,d", [(torch.float32, 70, 24), (torch.bfloat16, 130, 224)])
def test_attention_dropout_kernel_matches_plain(card, dtype, n, d):
    """K2 at rate 0.15: the kernel keeps exactly the probabilities the plain
    version keeps (an output row with one key dropped differently would
    move by about |v| / n), and the statistics stay the undropped ones."""
    rng = np.random.default_rng(n)
    q, k, v, mask = _attn_inputs(rng, card, dtype, n, d)
    seed = -123456789
    before = kernels.LAUNCHES["attention_fwd_dropout"]
    got, stats = attn.attention_fwd(q, k, v, mask, 0.15, seed, return_stats=True)
    want, stats_ref = attn.attention_plain(q, k, v, mask, 0.15, seed)
    undropped, _ = attn.attention_plain(q, k, v, mask)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["attention_fwd_dropout"] == before + 1
    scale = float(want.float().abs().max())
    assert _err(got, want) <= (2e-5 if dtype == torch.float32 else 2 * _bf16_ulp(scale))
    assert _err(got, undropped) > 10 * _err(got, want)
    assert _err(stats[..., 0], stats_ref[..., 0]) <= 1e-4
    rel_l = ((stats[..., 1] - stats_ref[..., 1]).abs() / stats_ref[..., 1]).max()
    assert float(rel_l) <= (1e-5 if dtype == torch.float32 else 1e-4)


def _bwd_tolerance(dtype, want):
    scale = float(want.float().abs().max())
    return 1e-4 * scale if dtype == torch.float32 else 4 * _bf16_ulp(scale)


@pytest.mark.parametrize("rate", [0.0, 0.15])
@pytest.mark.parametrize("dtype,n,d", [
    (torch.float32, 70, 24), (torch.float32, 33, 256), (torch.bfloat16, 40, 224),
    (torch.bfloat16, 130, 224), (torch.bfloat16, 200, 224),
])
def test_attention_backward_kernels_match_plain(card, dtype, n, d, rate):
    """K3 (dQ) and K4 (dK, dV) from the same forward output and statistics
    as the plain backward; sequences that end inside a tile."""
    rng = np.random.default_rng(n * 7 + d)
    q, k, v, mask = _attn_inputs(rng, card, dtype, n, d)
    dout = _on(rng.normal(0, 1, q.shape).astype(np.float32), card, dtype)
    out, stats = attn.attention_fwd(q, k, v, mask, rate, 77, return_stats=True)
    before = (kernels.LAUNCHES["attention_bwd_dq"], kernels.LAUNCHES["attention_bwd_dkv"])
    got = attn.attention_bwd(q, k, v, out, stats, dout, mask, rate, 77)
    want = attn.attention_bwd_plain(q, k, v, out, stats, dout, mask, rate, 77)
    torch.cuda.synchronize()
    assert (kernels.LAUNCHES["attention_bwd_dq"], kernels.LAUNCHES["attention_bwd_dkv"]) == (
        before[0] + 1, before[1] + 1)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape == q.shape
        assert _err(a, b) <= _bwd_tolerance(dtype, b), name
        mean_rel = (a.float() - b.float()).abs().mean() / b.float().abs().mean()
        assert float(mean_rel) <= 2.0 ** -7, name


def test_attention_autograd_round_trip(card):
    """flash_attention_train on the card: forward K2 with dropout, backward
    K3 + K4, against autograd through the plain forward (f32)."""
    rng = np.random.default_rng(3)
    q, k, v, mask = _attn_inputs(rng, card, torch.float32, 45, 16)
    w = _on(rng.normal(0, 1, q.shape).astype(np.float32), card)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = dict(kernels.LAUNCHES)
    out = attn.flash_attention_train(*leaves, mask, dropout_rate=0.25, seed=5)
    (out * w).sum().backward()
    got = [t.grad for t in leaves]
    for key in ("attention_fwd_dropout", "attention_bwd_dq", "attention_bwd_dkv"):
        assert kernels.LAUNCHES[key] == before.get(key, 0) + 1, key
    ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ref, _ = attn.attention_plain(*ref_leaves, mask, 0.25, 5)
    (ref * w).sum().backward()
    for a, t in zip(got, ref_leaves):
        assert _err(a, t.grad) <= 1e-4 * float(t.grad.abs().max())


_ROIS = np.array([
    [0, 0, 64, 64], [0, 0, 230, 230], [3.2, 7.7, 251.0, 11.1], [-5, -5, 40, 60],
    [0, 0, 256, 256], [4.0, 4.0, 4.0, 4.0], [100.5, 20.25, 140.0, 250.0],
], np.float32)
_EDGE_ROIS = np.array([[90.0, 40.0, 370.0, 52.0], [40.0, 90.0, 52.0, 370.0],
                       [300.0, 300.0, 383.0, 383.0]], np.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["mixed", "clamped_multitile"])
def test_roi_align_kernel_matches_plain(card, dtype, case):
    """Partly-outside and zero-area RoIs, and RoIs hugging the packed
    pyramid's edge (the regime of the JAX package's clamped multi-tile
    regression test)."""
    rng = np.random.default_rng(7)
    sizes, hw, rois = (((64, 32, 16, 8), (256, 256), _ROIS) if case == "mixed"
                       else ((96, 48, 24, 12), (384, 384), _EDGE_ROIS))
    feats = {k: _on(rng.normal(0, 1, (2, s, s, 8)).astype(np.float32), card, dtype)
             for k, s in zip("0123", sizes)}
    boxes = _on(np.stack([rois, rois[::-1]]), card)
    before = kernels.LAUNCHES["roi_align_fwd"]
    got = ra.multiscale_roi_align(feats, boxes, hw)
    packed, shapes, offsets = ra.pack_pyramid(feats)
    want = ra.roi_align_plain(packed, ra.roi_sample_params(boxes, shapes, offsets, hw, 7, 0))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["roi_align_fwd"] == before + 1
    assert got.shape == (2, len(rois), 7, 7, 8) and got.dtype == dtype
    assert _err(got, want) <= (1e-5 if dtype == torch.float32 else 3.2e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["mixed", "clamped_multitile"])
def test_roi_align_backward_kernel_matches_plain(card, dtype, case):
    """K6 against the plain scatter-add on the same RoIs as the forward test;
    the result lands in the pyramid's dtype."""
    rng = np.random.default_rng(8)
    sizes, hw, rois = (((64, 32, 16, 8), (256, 256), _ROIS) if case == "mixed"
                       else ((96, 48, 24, 12), (384, 384), _EDGE_ROIS))
    feats = {k: _on(rng.normal(0, 1, (2, s, s, 8)).astype(np.float32), card, dtype)
             for k, s in zip("0123", sizes)}
    boxes = _on(np.stack([rois, rois[::-1]]), card)
    packed, shapes, offsets = ra.pack_pyramid(feats)
    params = ra.roi_sample_params(boxes, shapes, offsets, hw, 7, 0)
    g = _on(rng.normal(0, 1, (2, len(rois), 7, 7, 8)).astype(np.float32), card, dtype)
    before = kernels.LAUNCHES["roi_align_bwd"]
    got = ra.roi_align_bwd(g, params, tuple(packed.shape), dtype)
    want = ra.roi_align_bwd_plain(g, params, tuple(packed.shape), dtype)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["roi_align_bwd"] == before + 1
    assert got.dtype == dtype and got.shape == packed.shape
    scale = float(want.float().abs().max())
    assert _err(got, want) <= (1e-5 * scale if dtype == torch.float32 else _bf16_ulp(scale))


def test_roi_align_autograd_round_trip(card):
    """multiscale_roi_align on the card: forward K5, backward K6 through the
    pyramid packing to every level, against autograd through the plain
    forward (f32)."""
    rng = np.random.default_rng(9)
    feats = {k: _on(rng.normal(0, 1, (2, s, s, 8)).astype(np.float32), card).requires_grad_()
             for k, s in zip("0123", (64, 32, 16, 8))}
    boxes = _on(np.stack([_ROIS, _ROIS[::-1]]), card)
    w = _on(rng.normal(0, 1, (2, len(_ROIS), 7, 7, 8)).astype(np.float32), card)
    before = (kernels.LAUNCHES["roi_align_fwd"], kernels.LAUNCHES["roi_align_bwd"])
    (ra.multiscale_roi_align(feats, boxes, (256, 256)) * w).sum().backward()
    assert (kernels.LAUNCHES["roi_align_fwd"], kernels.LAUNCHES["roi_align_bwd"]) == (
        before[0] + 1, before[1] + 1)
    got = {k: t.grad.clone() for k, t in feats.items()}
    for t in feats.values():
        t.grad = None
    packed, shapes, offsets = ra.pack_pyramid(feats)
    params = ra.roi_sample_params(boxes, shapes, offsets, (256, 256), 7, 0)
    (ra.roi_align_plain(packed, params) * w).sum().backward()
    for k, t in feats.items():
        assert _err(got[k], t.grad) <= 1e-5 * float(t.grad.abs().max()), k
