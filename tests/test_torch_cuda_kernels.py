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
max|plain|). RoIAlign's backward sums in another order than the plain
version (f32 1e-5 of max|plain|; bf16 one ulp of max|plain|), writes exact
zeros outside the RoIs' footprints and gives the same bits in two launches. Dropout masks are equal bit
for bit, and the attention backward gives the same bits in two launches.
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
@pytest.mark.parametrize("rows,d", [(1, 32), (77, 896), (13, 104), (9, 1000), (512, 384), (512, 896),
                                    (6656, 384), (6656, 896)])
def test_layer_norm_kernel_matches_plain(card, rows, d, dtype, residual):
    """Rows that leave a block part-empty; widths that leave lanes idle; the
    request's row counts at its widths (the residual form on the ring, the
    plain form on the rows design)."""
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


def _ln_inputs(dev, dtype, shape, n, residual, seed):
    """x [B, N, d] sliced to x[:, :n] where n < N, residual [B, n, d], w, b."""
    rng = np.random.default_rng(seed)
    full = _on(rng.normal(1.0, 3.0, shape).astype(np.float32), dev, dtype)
    x = full[:, :n]
    r = (_on(rng.normal(0.0, 1.0, x.shape).astype(np.float32), dev, dtype) if residual else None)
    d = shape[-1]
    w = _on(rng.normal(1.0, 0.2, (d,)).astype(np.float32), dev)
    b = _on(rng.normal(0.0, 0.2, (d,)).astype(np.float32), dev)
    return x, r, w, b


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d", [(1, 384), (1, 896), (15, 896), (16, 896), (17, 896), (7, 384), (8, 384),
                                    (9, 384), (512, 384), (6656, 896), (16383, 896), (16384, 896),
                                    (16385, 384), (25088, 896)])
def test_layer_norm_designs_match_plain(card, rows, d, dtype, residual):
    """Both hand-written designs at the fixed widths, as the kernel chooses
    them: the residual form always on the ring; the plain form on the rows
    design below 16,384 rows and on the ring from there (16,383 / 16,384 /
    16,385 sit on either side). One row, a tile's edge +- 1 row (a rows
    block holds 16 bf16 / 8 f32 rows at 896, a ring tile 2 / 1, a ring
    block's first sweep 4 or 8 tiles) and the request's row counts."""
    x, r, w, b = _ln_inputs(card, dtype, (1, rows, d), rows, residual, rows + d)
    got = ln._layer_norm_cuda(x, w, b, 1e-6, r)
    want = ln.layer_norm_plain(x, w, b, residual=r)
    torch.cuda.synchronize()
    assert _err(got, want) <= (1e-5 if dtype == torch.float32 else 3.2e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,n", [((8, 3136, 896), 3072), ((24, 700, 896), 683), ((3, 80, 896), 77),
                                     ((2, 5, 384), 3), ((4, 19, 384), 17)])
def test_layer_norm_reads_a_batch_strided_view(card, shape, n, dtype):
    """x[:, :n] of a contiguous [B, N, d], n not a multiple of a tile (but
    3072), read in place by the ring (24,576 and 16,392 rows) and by the
    rows design (the rest): the output contiguous, equal to the plain
    version of the view's contiguous copy; FusedLayerNorm passes the view
    through as the final norm does, allocating its output and no copy of x."""
    x, _, w, b = _ln_inputs(card, dtype, shape, n, False, n)
    assert not x.is_contiguous() and ln.row_layout(x) == (n, shape[1] * shape[2])
    got = ln._layer_norm_cuda(x, w, b, 1e-6, None)
    want = ln.layer_norm_plain(x.contiguous(), w, b)
    torch.cuda.synchronize()
    assert got.is_contiguous() and got.shape == x.shape
    assert _err(got, want) <= (1e-5 if dtype == torch.float32 else 3.2e-2)
    layer = ln.FusedLayerNorm(shape[-1], dtype=dtype).to(card).eval()
    with torch.no_grad():
        layer.weight.copy_(w)
        layer.bias.copy_(b)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        y = layer(x)
        torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - before < 1.5 * y.numel() * y.element_size()
    assert _err(y, want) <= (1e-5 if dtype == torch.float32 else 3.2e-2)


def test_layer_norm_kernel_refuses_what_it_does_not_take(card):
    """A view whose rows are not contiguous, a strided residual; and, at the
    C entry, a row count that is not a whole number of batches."""
    x = torch.randn(2, 8, 64, device=card)
    w, b = torch.ones(32, device=card), torch.zeros(32, device=card)
    with pytest.raises(ValueError, match="contiguous rows"):
        ln.fused_layer_norm(x[..., :32], w, b)
    xs = torch.randn(2, 4, 32, device=card)
    with pytest.raises(ValueError, match="residual"):
        ln.fused_layer_norm(xs, w, b, residual=torch.randn(2, 32, 4, device=card).transpose(1, 2))
    out = torch.empty_like(xs)
    code = kernels.library().tf_layer_norm(xs.data_ptr(), None, w.data_ptr(), b.data_ptr(), out.data_ptr(),
                                           8, 32, 3, 96, 1e-6, 0, kernels.stream_handle(card))
    assert code != 0


# bf16 sequence lengths around the forward's 64-key stages and 128-query
# blocks: one query, whole stages (64, 128, 192), one past or short of a
# block (127, 129), and a length that ends inside both (700).
BF16_EDGE_NS = (1, 64, 127, 128, 129, 192, 700)


@pytest.mark.parametrize("dtype,n,d", [
    (torch.float32, 70, 24),
    (torch.float32, 129, 224),
    (torch.bfloat16, 40, 224),
    (torch.bfloat16, 65, 224),
    (torch.bfloat16, 130, 224),
    (torch.bfloat16, 200, 224),
    *((torch.bfloat16, n, 224) for n in BF16_EDGE_NS),
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


@pytest.mark.parametrize("view", [False, True])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [300, 100, 77, 1023])
def test_layer_norm_kernel_takes_a_width_not_a_multiple_of_8(card, d, dtype, residual, view):
    """Widths the 16-byte designs cannot read: 300 (the heatmap fusion's
    tokens; 8-byte loads in both types), 100 (8-byte loads in both types),
    77 and 1023 (scalar loads), in both forms, contiguous and as the
    batch-strided view x[:, :n] of a [B, N, d] whose batch stride is odd in
    elements where d is (the final norm's read), each launched once."""
    shape, n = ((3, 37, d), 29) if view else ((1, 333, d), 333)
    x, r, w, b = _ln_inputs(card, dtype, shape, n, residual, d + n)
    assert x.is_contiguous() != view
    kind = "residual_layer_norm" if residual else "layer_norm"
    before = kernels.LAUNCHES[kind]
    got = ln.fused_layer_norm(x, w, b, residual=r)
    want = ln.layer_norm_plain(x.contiguous(), w, b, residual=r)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[kind] == before + 1
    assert got.is_contiguous() and got.shape == x.shape and got.dtype == dtype
    assert _err(got, want) <= (1e-5 if dtype == torch.float32 else 3.2e-2)


def test_layer_norm_kernel_refuses_a_width_over_1024(card):
    x, w = torch.zeros(3, 1032, device=card), torch.ones(1032, device=card)
    with pytest.raises(ValueError, match="1 to 1024"):
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
    before = kernels.LAUNCHES["layer_norm"]
    y = layer(x)
    assert kernels.LAUNCHES["layer_norm"] == before + 1
    y.sum().backward()
    assert x.grad is not None and layer.weight.grad is not None


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_backward_matches_plain_autograd(card, dtype, residual):
    """layer_norm (K1 forward, closed-form backward) against autograd through
    layer_norm_plain, 3,000 rows of 896: each gradient relative to its
    largest entry, dx (and dresidual) 1e-4 in f32 and two bf16 ulps (2^-7)
    in bf16, dweight and dbias 1e-4."""
    g = torch.Generator(device=card).manual_seed(3)
    x = (torch.randn(3, 1000, 896, device=card, generator=g) * 3 + 2).to(dtype)
    r = torch.randn(3, 1000, 896, device=card, generator=g).to(dtype) if residual else None
    w = torch.randn(896, device=card, generator=g) * 0.2 + 1
    b = torch.randn(896, device=card, generator=g) * 0.2
    cot = torch.randn(3, 1000, 896, device=card, generator=g).to(dtype)
    grads = []
    for fn in (ln.layer_norm, ln.layer_norm_plain):
        ins = [t.detach().requires_grad_() for t in (x, w, b) + ((r,) if residual else ())]
        fn(ins[0], ins[1], ins[2], 1e-6, ins[3] if residual else None).backward(cot)
        grads.append([t.grad for t in ins])
    for i, (a, want) in enumerate(zip(*grads)):
        tol = 2 ** -7 if i in (0, 3) and dtype == torch.bfloat16 else 1e-4
        assert a.dtype == want.dtype
        assert float((a.float() - want.float()).abs().max()) <= tol * float(want.float().abs().max())


def _attn_inputs(rng, dev, dtype, n, d, b=2, h=3):
    q, k, v = (_on(rng.normal(0, 1, (b, n, h, d)).astype(np.float32), dev, dtype) for _ in range(3))
    mask = np.zeros((b, n), bool)
    mask[0, n - 9:] = True
    return q, k, v, _on(mask, dev)


@pytest.mark.parametrize("dtype,n,d", [
    (torch.float32, 70, 24), (torch.bfloat16, 130, 224), *((torch.bfloat16, n, 224) for n in BF16_EDGE_NS),
])
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


@pytest.mark.parametrize("rate", [0.0, 0.15])
def test_attention_kernel_with_a_padded_stage(card, rate):
    """A whole 64-key stage of one batch row is padding (keys 64-127 of
    192): its probabilities vanish under the other stages' row maximum; the
    other row has a padded tail."""
    rng = np.random.default_rng(192)
    q, k, v, _ = _attn_inputs(rng, card, torch.bfloat16, 192, 224)
    mask = np.zeros((2, 192), bool)
    mask[0, 64:128] = True
    mask[1, -9:] = True
    mask = _on(mask, card)
    got, stats = attn.attention_fwd(q, k, v, mask, rate, 31, return_stats=True)
    want, stats_ref = attn.attention_plain(q, k, v, mask, rate, 31)
    torch.cuda.synchronize()
    assert _err(got, want) <= 2 * _bf16_ulp(float(want.float().abs().max()))
    mean_rel = (got.float() - want.float()).abs().mean() / want.float().abs().mean()
    assert float(mean_rel) <= 2.0 ** -7
    assert _err(stats[..., 0], stats_ref[..., 0]) <= 1e-4
    assert float(((stats[..., 1] - stats_ref[..., 1]).abs() / stats_ref[..., 1]).max()) <= 1e-4


def _bwd_tolerance(dtype, want):
    scale = float(want.float().abs().max())
    return 1e-4 * scale if dtype == torch.float32 else 4 * _bf16_ulp(scale)


@pytest.mark.parametrize("rate", [0.0, 0.15])
@pytest.mark.parametrize("dtype,n,d", [
    (torch.float32, 70, 24), (torch.float32, 33, 256), (torch.bfloat16, 40, 224),
    (torch.bfloat16, 130, 224), (torch.bfloat16, 200, 224), (torch.bfloat16, 1, 224),
    (torch.bfloat16, 64, 224), (torch.bfloat16, 192, 224), (torch.bfloat16, 700, 224),
])
def test_attention_backward_kernels_match_plain(card, dtype, n, d, rate):
    """K3 (dQ) and K4 (dK, dV) from the same forward output and statistics
    as the plain backward; sequences that end inside a tile (40, 130, 200,
    700), fill whole tiles (64, 192) or hold one query."""
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
        if n == 1 and rate == 0.0 and name != "dv":
            # One key: P = 1, O = V, so dS = dO.V - dO.O is 0 up to the f32
            # rounding of two sums of 224 products, taken in another order
            # on each side; dQ and dK are that noise times |k| or |q|.
            assert _err(a, b) <= 1e-5, name
            continue
        assert _err(a, b) <= _bwd_tolerance(dtype, b), name
        mean_rel = (a.float() - b.float()).abs().mean() / b.float().abs().mean()
        assert float(mean_rel) <= 2.0 ** -7, name


@pytest.mark.parametrize("rate", [0.0, 0.15])
def test_attention_backward_kernels_are_deterministic(card, rate):
    """No atomics: two launches of K3 and K4 on the same inputs give the same
    bits (N 700 ends inside a tile of either kernel)."""
    rng = np.random.default_rng(11)
    q, k, v, mask = _attn_inputs(rng, card, torch.bfloat16, 700, 224)
    dout = _on(rng.normal(0, 1, q.shape).astype(np.float32), card, torch.bfloat16)
    out, stats = attn.attention_fwd(q, k, v, mask, rate, 9, return_stats=True)
    first = attn.attention_bwd(q, k, v, out, stats, dout, mask, rate, 9)
    second = attn.attention_bwd(q, k, v, out, stats, dout, mask, rate, 9)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


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


@pytest.mark.parametrize("layout", ["bhnd", "blhd"])
@pytest.mark.parametrize("dtype,n,d", [
    (torch.float32, 70, 24), (torch.float32, 33, 256), (torch.bfloat16, 130, 224),
    *((torch.bfloat16, n, 224) for n in BF16_EDGE_NS),
])
def test_self_attention_kernel_matches_plain(card, dtype, n, d, layout):
    """K7 in both layouts (read through strides, no transpose copy) against
    its plain version, a padded key tail on one row."""
    rng = np.random.default_rng(n + d + 1)
    q, k, v, mask = _attn_inputs(rng, card, dtype, n, d)
    if layout == "bhnd":
        q, k, v = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        fn = attn.flash_self_attention
        want = attn.self_attention_plain(q, k, v, mask)
    else:
        fn = attn.flash_self_attention_blhd
        want = attn.attention_plain(q, k, v, mask)[0]
    before = kernels.LAUNCHES["self_attention"]
    got = fn(q, k, v, mask)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["self_attention"] == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    scale = float(want.float().abs().max())
    assert _err(got, want) <= (2e-5 if dtype == torch.float32 else 2 * _bf16_ulp(scale))
    mean_rel = (got.float() - want.float()).abs().mean() / want.float().abs().mean()
    assert float(mean_rel) <= 2.0 ** -7


def test_self_attention_kernel_refuses_what_it_does_not_take(card):
    """K7's bf16 path is built for D 224 only, and it has no backward: an
    input that requires grad under grad mode raises; under no_grad it runs."""
    q = torch.zeros(1, 1, 8, 24, dtype=torch.bfloat16, device=card)
    with pytest.raises(ValueError, match="head dim must be one of"):
        attn.flash_self_attention(q, q, q)
    x = torch.randn(1, 2, 8, 16, device=card, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        attn.flash_self_attention(x, x, x)
    with torch.no_grad():
        attn.flash_self_attention_blhd(x, x, x)


_ROIS = np.array([
    [0, 0, 64, 64], [0, 0, 230, 230], [3.2, 7.7, 251.0, 11.1], [-5, -5, 40, 60],
    [0, 0, 256, 256], [4.0, 4.0, 4.0, 4.0], [100.5, 20.25, 140.0, 250.0],
], np.float32)
_EDGE_ROIS = np.array([[90.0, 40.0, 370.0, 52.0], [40.0, 90.0, 52.0, 370.0],
                       [300.0, 300.0, 383.0, 383.0]], np.float32)


# A RoI across several K6 output tiles (8 packed rows x 16 cells) in level 1,
# whose last rows share a tile with level 2's first (levels of 60, 30, 15, 8
# rows: tiles straddle both level boundaries), and a level-2 RoI there.
_TILE_ROIS = np.array([[0.0, 150.0, 230.0, 240.0], [0.0, 0.0, 240.0, 240.0], [5.0, 5.0, 50.0, 50.0]],
                      np.float32)
# Level-3 RoIs with 8 or more samples a bin per axis (a 64-row level 3 at a
# 512-pixel image).
_DENSE_ROIS = np.array([[0.0, 0.0, 480.0, 470.0], [0.0, 0.0, 512.0, 512.0], [20.0, 7.5, 500.0, 505.0]],
                       np.float32)
# case: (level sizes, image size, RoIs of image 0 (image 1 takes them
# reversed), batch, channels)
_ROI_CASES = {
    "mixed": ((64, 32, 16, 8), (256, 256), _ROIS, 2, 8),
    "clamped_multitile": ((96, 48, 24, 12), (384, 384), _EDGE_ROIS, 2, 8),
    "c64": ((64, 32, 16, 8), (256, 256), _ROIS, 2, 64),
    "c256": ((64, 32, 16, 8), (256, 256), _ROIS, 2, 256),
    "b1": ((64, 32, 16, 8), (256, 256), _ROIS, 1, 8),
    "tiles_and_levels": ((60, 30, 15, 8), (240, 240), _TILE_ROIS, 2, 16),
    "identical": ((64, 32, 16, 8), (256, 256), np.repeat(_ROIS[6:7], 64, axis=0), 2, 8),
    "dense_samples": ((32, 32, 32, 64), (512, 512), _DENSE_ROIS, 2, 8),
    "no_rois": ((64, 32, 16, 8), (256, 256), np.zeros((0, 4), np.float32), 2, 8),
}


def _roi_case(case, rng, dtype, card):
    sizes, hw, rois, bsz, c = _ROI_CASES[case]
    feats = {k: _on(rng.normal(0, 1, (bsz, s, s, c)).astype(np.float32), card, dtype)
             for k, s in zip("0123", sizes)}
    boxes = _on(np.stack([rois, rois[::-1]])[:bsz], card)
    packed, shapes, offsets = ra.pack_pyramid(feats)
    return feats, boxes, hw, packed, ra.roi_sample_params(boxes, shapes, offsets, hw, 7, 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [k for k in _ROI_CASES if k != "no_rois"])
def test_roi_align_kernel_matches_plain(card, dtype, case):
    """Partly-outside and zero-area RoIs, RoIs hugging the packed pyramid's
    edge (the regime of the JAX package's clamped multi-tile regression
    test), 64 and 256 channels, one image, RoIs across tiles and level
    boundaries, 64 identical RoIs, and 8 or more samples a bin."""
    rng = np.random.default_rng(7)
    feats, boxes, hw, packed, params = _roi_case(case, rng, dtype, card)
    before = kernels.LAUNCHES["roi_align_fwd"]
    got = ra.multiscale_roi_align(feats, boxes, hw)
    want = ra.roi_align_plain(packed, params)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["roi_align_fwd"] == before + 1
    assert got.shape == want.shape == (boxes.shape[0], boxes.shape[1], 7, 7, packed.shape[-1])
    assert got.dtype == dtype
    assert _err(got, want) <= (1e-5 if dtype == torch.float32 else 3.2e-2)


def _footprint_cover(params, shape):
    """[B, H_tot, W_max] bool: the cells inside some RoI's footprint."""
    foot = ra.roi_footprints(params).cpu().numpy()
    cover = np.zeros(shape[:3], bool)
    for b, rects in enumerate(foot):
        for y0, y1, x0, x1 in rects:
            cover[b, y0:y1 + 1, x0:x1 + 1] = True
    return torch.from_numpy(cover)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(_ROI_CASES))
def test_roi_align_backward_kernel_matches_plain(card, dtype, case):
    """K6 against the plain scatter-add on the forward test's cases and with
    no RoI at all; the result lands in the pyramid's dtype, every cell
    outside the RoIs' footprints (padding columns included) exactly 0, and
    two launches give the same bits."""
    rng = np.random.default_rng(8)
    _, boxes, _, packed, params = _roi_case(case, rng, dtype, card)
    shape = tuple(packed.shape)
    g = _on(rng.normal(0, 1, tuple(boxes.shape[:2]) + (7, 7, shape[-1])).astype(np.float32), card, dtype)
    before = kernels.LAUNCHES["roi_align_bwd"]
    got = ra.roi_align_bwd(g, params, shape, dtype)
    want = ra.roi_align_bwd_plain(g, params, shape, dtype)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["roi_align_bwd"] == before + 1
    assert got.dtype == dtype and got.shape == packed.shape
    scale = float(want.float().abs().max())
    if case == "no_rois":
        assert scale == 0.0 and not got.any()
    else:
        assert _err(got, want) <= (1e-5 * scale if dtype == torch.float32 else _bf16_ulp(scale))
    outside = ~_footprint_cover(params, shape)
    assert not got.cpu()[outside].any()
    assert torch.equal(ra.roi_align_bwd(g, params, shape, dtype), got)


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


# --------------------------------------- model build: head dims the kernels take
def test_model_with_an_unsupported_head_dim_fails_at_build(card):
    """A bf16 model whose fusion head dim the attention kernels are not
    compiled for raises in TransFusion.__init__, not in a step; turning
    flash attention off builds it."""
    from dataclasses import replace

    from transfusion_torch.models.detector import DetectorConfig
    from transfusion_torch.models.transfusion import FusionConfig, TransFusion, TransFusionConfig
    from transfusion_torch.models.text_encoder import BertConfig

    cfg = TransFusionConfig(
        detector=DetectorConfig(stage_sizes=(1, 1, 1, 1), dtype=torch.bfloat16),
        fusion=FusionConfig(fpn_features=(3,), patch_h=(1,), patch_w=(1,), num_layers=(1,),
                            token_dim=64, num_heads=2, use_flash_attention=True),
        bert=BertConfig(vocab_size=64, hidden_size=16, num_layers=1, num_heads=2,
                        intermediate_size=32, max_position_embeddings=16),
        out_mlp=64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        TransFusion(cfg, device=card)
    TransFusion(replace(cfg, fusion=replace(cfg.fusion, use_flash_attention=False)), device=card)
