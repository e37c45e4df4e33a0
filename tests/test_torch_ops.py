"""Parity of the port's ops (transfusion_torch/ops) with the JAX package's,
on the CPU where every kernel wrapper runs its plain version. The JAX side
runs as its own tests run it: Pallas in interpret mode, or impl="xla".
Inputs are made with numpy from a seed and handed to both."""

import ast
import importlib
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.roi_align_oracle import roi_align_oracle
from tests.torch_threads import cap_torch_threads  # noqa: F401
from transfusion_torch.models.detector import rescale_boxes
from transfusion_torch.ops import attention as t_attn
from transfusion_torch.ops import boxes as t_boxes
from transfusion_torch.ops import layer_norm as t_ln
from transfusion_torch.ops import roi_align as t_roi
from transfusion_tpu.ops import attention as j_attn
from transfusion_tpu.ops import boxes as j_boxes
from transfusion_tpu.ops import roi_align as j_roi
from transfusion_tpu.ops.layer_norm import fused_layer_norm as j_fused_ln
from transfusion_tpu.models.detector import rescale_boxes as j_rescale_boxes
from transfusion_tpu.ops.nms import batched_nms as j_batched_nms
from transfusion_tpu.ops.nms import class_nms_multi as j_class_nms_multi

# The module: the package's exports (JAX's ``ops.__all__``) bind ``ops.nms`` to the function.
t_nms = importlib.import_module("transfusion_torch.ops.nms")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(x, dtype=None):
    out = torch.from_numpy(np.ascontiguousarray(x))
    return out if dtype is None else out.to(dtype)


# --------------------------------------------------------------- (a) K1 LN
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [32, 896, 384])
def test_layer_norm_matches_jax(rng, d, dtype, residual):
    """74 rows (not a multiple of the TPU kernel's 256-row block); d 384 at
    MiniLM's eps 1e-12 (the narration encoder's norms run K1 too), the
    others at the fusion's 1e-6. f32: 1e-5; bf16: outputs may differ by one
    bf16 ulp (|y| < 8 -> 3e-2) because the two packages sum the statistics
    in different orders."""
    eps = 1e-12 if d == 384 else 1e-6
    x = rng.normal(2.0, 3.0, (2, 37, d)).astype(np.float32)
    r = rng.normal(0.0, 1.0, (2, 37, d)).astype(np.float32)
    w = rng.normal(1.0, 0.2, (d,)).astype(np.float32)
    b = rng.normal(0.0, 0.2, (d,)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = j_fused_ln(jnp.asarray(x).astype(jdt), jnp.asarray(w), jnp.asarray(b), eps,
                     residual=jnp.asarray(r).astype(jdt) if residual else None)
    got = t_ln.fused_layer_norm(_t(x, tdt), _t(w), _t(b), eps, residual=_t(r, tdt) if residual else None)
    assert got.dtype == tdt
    tol = 1e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), rtol=tol, atol=tol)


def test_layer_norm_row_layout_reads_views_in_place():
    """K1 reads x in place when its rows are contiguous within each batch:
    a contiguous tensor (one batch), the final norm's x[:, :n] of a [B, N, d]
    sequence (rows per batch n, batch stride N * d), leading dims that merge;
    anything else (a strided last dim, split rows, unmergeable batch dims)
    gets no layout, and FusedLayerNorm copies it first. On the CPU the view
    and its copy normalise alike."""
    x = torch.randn(3, 10, 16)
    assert t_ln.row_layout(x) == (30, 0)
    assert t_ln.row_layout(x[:, :7]) == (7, 160)
    assert t_ln.row_layout(torch.randn(2, 3, 10, 16)[:, :, :7]) == (7, 160)
    assert t_ln.row_layout(x[:, :, :8]) is None
    assert t_ln.row_layout(x[:, ::2]) is None
    assert t_ln.row_layout(torch.randn(2, 3, 10, 16)[:, :2, :7]) is None
    layer = t_ln.FusedLayerNorm(16).eval()
    assert torch.equal(layer(x[:, :7]), layer(x[:, :7].contiguous()))


def test_minilm_layer_norms_take_k1_in_eval_and_the_plain_version_in_training(monkeypatch):
    """flax_layer_norm runs K1's wrapper (fused_layer_norm) in eval, the
    residual post-norms with their add folded in: 1 + 2 x layers calls. In
    training it runs the same wrapper through layer_norm's closed-form
    backward (on the CPU the wrapper's plain version): the same calls, the
    same output, and parameter gradients equal to plain autograd's (f32,
    1e-5)."""
    from transfusion_torch.models import text_encoder as te

    calls = []

    def counting(x, w, b, eps, residual=None):
        calls.append(residual is not None)
        return t_ln.layer_norm_plain(x, w, b, eps, residual)

    cfg = te.BertConfig(vocab_size=50, hidden_size=16, num_layers=2, num_heads=2, intermediate_size=32,
                        max_position_embeddings=16, dropout=0.0)
    enc = te.BertEncoder(cfg).eval()
    ids, mask = torch.randint(0, 50, (2, 8)), torch.ones(2, 8, dtype=torch.int64)
    cot = torch.randn(2, 8, 16)
    with monkeypatch.context() as m:
        m.setattr(te, "layer_norm", t_ln.layer_norm_plain)  # plain autograd as the reference
        (enc.train()(ids, mask) * cot).sum().backward()
    want_grads = {n: p.grad.clone() for n, p in enc.named_parameters() if p.grad is not None}
    enc.zero_grad(set_to_none=True)
    monkeypatch.setattr(t_ln, "fused_layer_norm", counting)
    with torch.no_grad():
        want = enc.eval()(ids, mask)
    assert calls == [False, True, True, True, True]
    got = enc.train()(ids, mask)
    assert calls == [False, True, True, True, True] * 2
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    (got * cot).sum().backward()
    ln_names = [n for n in want_grads if "LayerNorm" in n]
    assert len(ln_names) == 10
    for n, g in want_grads.items():
        torch.testing.assert_close(dict(enc.named_parameters())[n].grad, g, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_vjp_matches_jax_custom_vjp(rng, dtype, residual):
    """layer_norm's closed-form backward against JAX's custom_vjp of K1
    (_fused_ln_bwd / _fused_res_ln_bwd) on one cotangent, 74 rows of 896 at
    eps 1e-6. dx (and dresidual, the same) and dweight, dbias: f32 1e-4
    relative to each gradient's largest entry; bf16 3e-2 (dx is rounded to
    bf16, one ulp)."""
    d, eps = 896, 1e-6
    x = rng.normal(2.0, 3.0, (2, 37, d)).astype(np.float32)
    r = rng.normal(0.0, 1.0, (2, 37, d)).astype(np.float32)
    w = rng.normal(1.0, 0.2, (d,)).astype(np.float32)
    b = rng.normal(0.0, 0.2, (d,)).astype(np.float32)
    cot = rng.normal(0.0, 1.0, (2, 37, d)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jx, jr = jnp.asarray(x).astype(jdt), jnp.asarray(r).astype(jdt)
    if residual:
        _, vjp = jax.vjp(lambda x_, r_, w_, b_: j_fused_ln(x_, w_, b_, eps, residual=r_), jx, jr,
                         jnp.asarray(w), jnp.asarray(b))
        want = vjp(jnp.asarray(cot).astype(jdt))
    else:
        _, vjp = jax.vjp(lambda x_, w_, b_: j_fused_ln(x_, w_, b_, eps), jx, jnp.asarray(w), jnp.asarray(b))
        want = vjp(jnp.asarray(cot).astype(jdt))
    tx, tr = _t(x, tdt).requires_grad_(), _t(r, tdt).requires_grad_()
    tw, tb = _t(w).requires_grad_(), _t(b).requires_grad_()
    y = t_ln.layer_norm(tx, tw, tb, eps, residual=tr if residual else None)
    y.backward(_t(cot, tdt))
    got = (tx.grad, tr.grad, tw.grad, tb.grad) if residual else (tx.grad, tw.grad, tb.grad)
    tol = 1e-4 if dtype == "float32" else 3e-2
    for g, ref in zip(got, want):
        ref = np.asarray(ref, np.float32)
        assert g.dtype == (tdt if g.dim() == 3 else torch.float32)
        np.testing.assert_allclose(g.float().numpy(), ref, rtol=0, atol=tol * float(np.abs(ref).max()))


# ------------------------------------------------------------ (b) K2 attention
@pytest.fixture(autouse=True, scope="module")
def warm_torch_exp():
    """A CPU runtime fault, not the port's: the first multi-threaded
    torch.exp of a process has been seen to compute whole worker-thread
    chunks up to 1e-4 off (about one fresh process in 250-400; the second
    call is right; JAX plays no part). A warm-up call takes that first call,
    so the attention parity checks (tolerance 2e-5) compare the port's
    arithmetic with JAX's. ROADMAP Queue 3 keeps the measurements."""
    torch.exp(torch.zeros(1 << 20))


def _qkv(rng, b=2, n=70, h=2, d=24):
    q, k, v = (rng.normal(0, 1, (b, n, h, d)).astype(np.float32) for _ in range(3))
    mask = np.zeros((b, n), bool)
    mask[0, 61:] = True
    return q, k, v, mask


def test_attention_matches_jax_flash_and_xla(rng):
    """D = 24 (not a power of two), a padded key tail on one batch row.
    f32 tolerance 2e-5 (the JAX package's own flash-vs-XLA bound); the
    (m, l) statistics match the TPU kernel's side output."""
    q, k, v, mask = _qkv(rng)
    got, stats = t_attn.attention_fwd(_t(q), _t(k), _t(v), _t(mask), return_stats=True)
    ref_flash = j_attn.flash_attention_train(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                             jnp.asarray(mask), dropout_rate=0.0, block_q=32)
    tr = lambda x: jnp.asarray(x).transpose(0, 2, 1, 3)  # noqa: E731
    ref_xla = j_attn.xla_self_attention(tr(q), tr(k), tr(v), jnp.asarray(mask)).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_flash), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_xla), rtol=2e-5, atol=2e-5)

    bias = jnp.where(jnp.asarray(mask), j_attn._NEG, 0.0).astype(jnp.float32)[:, None, :]
    _, res = j_attn._flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bias,
                               jnp.zeros((1, 1), jnp.int32), 0.0, 32)
    lse = np.asarray(res[-1])[:, :, : q.shape[1]]
    np.testing.assert_allclose(stats[..., 0].numpy(), lse[..., 0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(stats[..., 1].numpy(), lse[..., 32], rtol=1e-5, atol=1e-5)


def test_attention_bf16_matches_jax_flash(rng):
    """bf16 inputs, f32 softmax: one bf16 ulp of an O(1) output (1e-2)."""
    q, k, v, mask = _qkv(rng, n=40, d=16)
    got = t_attn.attention_fwd(*(_t(a, torch.bfloat16) for a in (q, k, v)), _t(mask))
    ref = j_attn.flash_attention_train(*(jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)),
                                       jnp.asarray(mask), dropout_rate=0.0, block_q=32)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), rtol=1e-2, atol=1e-2)


def test_attention_dropout_not_ported(rng):
    """Dropout at rates in [0, 1) is ported (tests/test_torch_train_ops.py
    holds it against JAX); a rate of 1 or more has no keep scale and is
    refused by the forward and the backward alike."""
    q, k, v, mask = _qkv(rng, n=8, d=8)
    with pytest.raises(ValueError, match="rate"):
        t_attn.attention_fwd(_t(q), _t(k), _t(v), _t(mask), dropout_rate=1.0)
    out, stats = t_attn.attention_fwd(_t(q), _t(k), _t(v), _t(mask), return_stats=True)
    with pytest.raises(ValueError, match="rate"):
        t_attn.attention_bwd(_t(q), _t(k), _t(v), out, stats, out, _t(mask), dropout_rate=1.5)


# ------------------------------------------------------------ (c) K5 RoIAlign
def _pyramid(rng, sizes, bsz, c=4):
    return {k: rng.normal(0, 1, (bsz, s, s, c)).astype(np.float32) for k, s in zip("0123", sizes)}


_ROIS = np.array([
    [0, 0, 64, 64], [0, 0, 230, 230], [3.2, 7.7, 251.0, 11.1], [-5, -5, 40, 60],
    [0, 0, 256, 256], [4.0, 4.0, 4.0, 4.0], [100.5, 20.25, 140.0, 250.0],
], np.float32)


def test_roi_align_matches_jax_xla_and_oracle(rng):
    """Adaptive sampling, partly-outside and zero-area RoIs, a sliver that
    spans many cells; f32 tolerance 1e-5 (summation order)."""
    feats = _pyramid(rng, (64, 32, 16, 8), 2)
    rois = np.stack([_ROIS, _ROIS[::-1]])
    got = t_roi.multiscale_roi_align({k: _t(v) for k, v in feats.items()}, _t(rois), (256, 256))
    ref = j_roi.multiscale_roi_align({k: jnp.asarray(v) for k, v in feats.items()},
                                     jnp.asarray(rois), (256, 256), impl="xla")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    lv = t_roi.fpn_levels(_t(rois[0])).numpy()
    np.testing.assert_array_equal(lv, np.asarray(j_roi.fpn_levels(jnp.asarray(rois[0]))))
    for i in range(len(_ROIS)):
        o = roi_align_oracle(feats[str(lv[i])][0], rois[0, i:i + 1], (64 >> lv[i]) / 256, ratio=0)
        np.testing.assert_allclose(got[0, i].numpy(), o[0], rtol=1e-4, atol=1e-5)


def test_roi_align_clamped_multitile_matches_jax_pallas(rng):
    """The regime of test_fused_pallas_roi_align_clamped_multitile_parity:
    RoIs hugging the packed pyramid's edge. Against the TPU kernel in
    interpret mode and the numpy oracle, f32 1e-4 / 1e-5."""
    feats = _pyramid(rng, (96, 48, 24, 12), 1)
    rois = np.array([[90.0, 40.0, 370.0, 52.0], [40.0, 90.0, 52.0, 370.0],
                     [300.0, 300.0, 383.0, 383.0]], np.float32)
    got = t_roi.multiscale_roi_align({k: _t(v) for k, v in feats.items()}, _t(rois[None]), (384, 384))
    ref = j_roi.multiscale_roi_align({k: jnp.asarray(v) for k, v in feats.items()},
                                     jnp.asarray(rois[None]), (384, 384), impl="pallas")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)
    lv = t_roi.fpn_levels(_t(rois)).numpy()
    for i in range(len(rois)):
        o = roi_align_oracle(feats[str(lv[i])][0], rois[i:i + 1], (96 >> lv[i]) / 384, ratio=0)
        np.testing.assert_allclose(got[0, i].numpy(), o[0], rtol=1e-4, atol=1e-5)


def test_roi_sample_params_match_jax(rng):
    feats = _pyramid(rng, (64, 32, 16, 8), 1)
    rois = _ROIS[None]
    _, shapes, offsets = t_roi.pack_pyramid({k: _t(v) for k, v in feats.items()})
    jpacked, jshapes, joffsets = j_roi.pack_pyramid({k: jnp.asarray(v) for k, v in feats.items()})
    assert [tuple(s) for s in jshapes] == shapes and list(joffsets) == offsets
    got = t_roi.roi_sample_params(_t(rois), shapes, offsets, (256, 256), 7, 0)
    ref = j_roi.roi_sample_params(jnp.asarray(rois), jshapes, joffsets, (256, 256), 7, 0)
    for key in ref:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), rtol=1e-6, err_msg=key)


# --------------------------------------------------------------- boxes / NMS
def test_boxes_match_jax(rng):
    a = rng.uniform(0, 50, (6, 4)).astype(np.float32)
    a[:, 2:] += a[:, :2]
    b = rng.uniform(-10, 60, (5, 4)).astype(np.float32)
    b[:, 2:] = b[:, :2] + np.abs(b[:, 2:])
    np.testing.assert_allclose(t_boxes.box_area(_t(b)).numpy(),
                               np.asarray(j_boxes.box_area(jnp.asarray(b))), rtol=1e-6)
    np.testing.assert_allclose(t_boxes.box_iou(_t(a), _t(b)).numpy(),
                               np.asarray(j_boxes.box_iou(jnp.asarray(a), jnp.asarray(b))), rtol=1e-6)
    np.testing.assert_allclose(t_boxes.clip_boxes(_t(b), 40, 30).numpy(),
                               np.asarray(j_boxes.clip_boxes(jnp.asarray(b), 40, 30)))
    np.testing.assert_array_equal(t_boxes.small_box_mask(_t(b), 20.0).numpy(),
                                  np.asarray(j_boxes.small_box_mask(jnp.asarray(b), 20.0)))
    deltas = rng.normal(0, 1, (6, 3, 4)).astype(np.float32) * 3
    for w in ((1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0)):
        np.testing.assert_allclose(
            t_boxes.BoxCoder(w).decode(_t(deltas), _t(a)).numpy(),
            np.asarray(j_boxes.BoxCoder(w).decode(jnp.asarray(deltas), jnp.asarray(a))),
            rtol=1e-5, atol=1e-4)
    hw_from = np.array([[480, 640], [768, 1024]], np.float32)
    for to_hw in ((1080, 1920), np.array([[1080, 1440], [720, 1280]], np.float32)):
        np.testing.assert_allclose(
            rescale_boxes(_t(np.stack([a[:5], b])), _t(hw_from), torch.as_tensor(to_hw)).numpy(),
            np.asarray(j_rescale_boxes(jnp.asarray(np.stack([a[:5], b])), hw_from, to_hw)),
            rtol=1e-6)


@pytest.mark.parametrize("block", [256, 16])
def test_nms_matches_jax_slot_by_slot(rng, block):
    """Quantised scores force ties, whose order must follow the stable
    descending sort; several blocks and an early stop (block 16). Integers
    must match exactly."""
    n = 300
    xy = rng.uniform(0, 200, (2, n, 2)).astype(np.float32)
    wh = rng.uniform(5, 60, (2, n, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + wh], -1)
    scores = (rng.integers(0, 20, (2, n)) / 20.0).astype(np.float32)
    valid = rng.uniform(0, 1, (2, n)) > 0.1
    classes = rng.integers(0, 3, (2, n))
    for max_keep in (40, 400):
        got = t_nms.class_nms_multi(_t(boxes), _t(scores), _t(classes), _t(valid), 0.5, max_keep, block)
        ref = j_class_nms_multi(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(classes),
                                    jnp.asarray(valid), 0.5, max_keep, block)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
        got = t_nms.batched_nms(_t(boxes[1]), _t(scores[1]), _t(classes[1]), _t(valid[1]), 0.5,
                                max_keep, block)
        ref = j_batched_nms(jnp.asarray(boxes[1]), jnp.asarray(scores[1]), jnp.asarray(classes[1]),
                            jnp.asarray(valid[1]), 0.5, max_keep, block)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))


# ------------------------------------------------ (g) no JAX in the port
def _port_files():
    pkg = os.path.join(REPO, "transfusion_torch")
    files = [os.path.join(REPO, "chip_smoke.py")] + [
        os.path.join(REPO, "scripts", f) for f in ("ab_attention_fwd.py", "ab_roi_align.py", "ab_layer_norm.py",
                                                   "ab_fusion_norms.py", "dp_cards.py")]
    for root, dirs, names in os.walk(pkg):
        dirs[:] = [d for d in dirs if d != "_build"]  # kernel build output, not package source
        files += [os.path.join(root, f) for f in names if f.endswith(".py")]
    return files


# The trainer slice's, the fusion options', the towers' and TTC head's, the
# data-parallel slice's, the model axis's, the other backbones', the heatmap
# family's and the host helpers' and tools' modules, each of which the scan
# must reach.
TRAINER_MODULES = ("config/loader.py", "config/derive.py", "data/tokenizer.py", "data/labels.py",
                   "data/annotations.py", "data/splits.py", "data/transforms.py",
                   "data/dataset.py", "data/loader.py", "models/transfusion.py", "models/fusion.py",
                   "models/fusion_variants.py", "train/losses.py", "weights.py", "train/step.py",
                   "train/optim.py", "metrics/sta_map.py", "runner/export.py",
                   "train/checkpoint.py", "runner/trainer.py", "runner/run_experiment.py",
                   "models/lm_encoders.py", "models/ttc_head.py", "data/hand_pose.py", "data/glove.py",
                   "parallel/mesh.py", "parallel/fsdp.py", "ops/batch_norm.py",
                   "parallel/tensor_parallel.py", "models/mobilenet.py", "models/dual_stream.py",
                   "data/readers.py", "models/misc_layers.py", "models/resnet_nao.py", "models/scnn.py",
                   "models/heatmap_fusion.py", "data/heatmaps.py", "data/snao.py", "data/epic_nao.py",
                   "metrics/hmap_metrics.py", "metrics/native.py", "utils/profiling.py",
                   "runner/callbacks.py", "runner/wandb_resume.py", "tools/label_extraction.py",
                   "tools/translate_checkpoint.py", "tools/evaluate_result_json.py",
                   "tools/postprocess_result_json.py", "tools/adapt_ttc_values.py",
                   "tools/produce_object_detections.py", "tools/compute_norm_stats.py",
                   "tools/extract_frames.py", "tools/generate_splits.py")


def test_port_imports_no_jax():
    files = _port_files()
    assert len(files) > 15
    for mod in TRAINER_MODULES:
        assert os.path.join(REPO, "transfusion_torch", mod) in files, mod
    banned = ("jax", "jaxlib", "flax", "optax", "orbax", "transfusion_tpu", "transformers",
              "sentencepiece")
    for path in files:
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            elif isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__":
                names = [getattr(a, "value", "") for a in node.args[:1]]
            for name in names:
                assert name.split(".")[0] not in banned, f"{path} imports {name}"


def test_chip_smoke_reads_registers_and_spills_per_kernel():
    """chip_smoke.py's reading of an ``nvcc -Xptxas -v`` log, which it
    prints and checks (no spill in a wgmma kernel): one row per entry
    function, its registers and spill bytes."""
    sys.path.insert(0, REPO)
    import chip_smoke

    log = (
        "ptxas info    : Compiling entry function '_Z8fwd_sm90v' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z8fwd_sm90v\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 254 registers, used 16 barriers\n"
        "ptxas info    : Compiling entry function '_Z6ln_f32v' for 'sm_90a'\n"
        "    8 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads\n"
        "ptxas info    : Used 40 registers, used 1 barriers\n")
    rows = chip_smoke.ptxas_report({"attention.cu": log})
    assert [(r["registers"], r["spill_stores"], r["spill_loads"]) for r in rows] == [(254, 0, 0), (40, 12, 16)]
    assert "fwd_sm90" in rows[0]["kernel"] and "ln_f32" in rows[1]["kernel"]
    assert {r["source"] for r in rows} == {"attention.cu"}


# ------------------------------------------- (h) CUDA by default, no fallback
def test_entry_points_default_to_cuda_and_raise_without_it():
    from transfusion_torch.device import resolve_device
    from transfusion_torch.models.detector import DetectorConfig, FasterRCNN
    from transfusion_torch.models.transfusion import TransFusion, flagship_config

    if torch.cuda.is_available():
        pytest.skip("this box has a CUDA device; the entry points would run there")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        TransFusion(flagship_config())
    with pytest.raises(RuntimeError, match="CUDA"):
        FasterRCNN(DetectorConfig(stage_sizes=(1, 1, 1, 1)))
    assert resolve_device("cpu").type == "cpu"
