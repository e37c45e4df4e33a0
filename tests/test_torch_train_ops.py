"""Parity of the port's training ops with the JAX package's, on the CPU
where every kernel wrapper runs its plain version; the JAX side runs as its
own tests run it (Pallas in interpret mode, or impl="xla"). Inputs are made
with numpy from a seed and handed to both. Random draws are the JAX
package's own ``jax.random.uniform`` arrays, regenerated from the same key
chain and passed to the port, so samplers agree slot by slot.

Tolerances: attention forward 2e-5 and its gradients 1e-4 (f32, the JAX
package's flash-vs-XLA bounds); RoIAlign gradients 1e-4 relative / 1e-5
absolute (f32 sums in another order); losses 1e-5 relative; the optimizer's
parameters 1e-5 relative (the same float32 arithmetic); masks, indices and
labels exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_threads import cap_torch_threads  # noqa: F401
from transfusion_torch.ops import attention as t_attn
from transfusion_torch.ops import matcher as t_match
from transfusion_torch.ops import roi_align as t_roi
from transfusion_torch.train import losses as t_loss
from transfusion_tpu.ops import attention as j_attn
from transfusion_tpu.ops import matcher as j_match
from transfusion_tpu.ops import roi_align as j_roi
from transfusion_tpu.train import losses as j_loss
from tests.test_torch_ops import warm_torch_exp  # noqa: F401  (autouse: see its docstring)


def _t(x, dtype=None):
    out = torch.from_numpy(np.ascontiguousarray(np.asarray(x)))
    return out if dtype is None else out.to(dtype)


def _draws(key, n):
    """The two uniform arrays ``_sample_parts`` draws from ``key``."""
    kp, kn = jax.random.split(key)
    return jax.random.uniform(kp, (n,)), jax.random.uniform(kn, (n,))


def _batched_draws(key, bsz, n):
    """Per-image draws under ``split(key, B)``, as the vmapped callers take
    them: (positive keys [B, n], negative keys [B, n]) as torch tensors."""
    pos, neg = jax.vmap(lambda k: _draws(k, n))(jax.random.split(key, bsz))
    return _t(pos), _t(neg)


# ------------------------------------------------- (a) K2 dropout, K3, K4
def test_dropout_mask_matches_jax_bit_for_bit():
    """The keep mask of every (batch, head) cell, at zero and non-zero
    global offsets, negative and positive seeds and three rates."""
    b, h, n = 2, 3, 40
    for seed, rate in ((-123456789, 0.15), (7, 0.5), (2 ** 31 - 1, 0.1)):
        got = t_attn.dropout_keep_mask(b, h, n, seed, rate, "cpu").numpy()
        for cell in range(b * h):
            want = j_attn._dropout_keep_mask(n, n, 0, 0, jnp.asarray(seed, jnp.int32), cell, rate)
            np.testing.assert_array_equal(got[cell // h, cell % h], np.asarray(want))
            part = j_attn._dropout_keep_mask(8, 16, 24, 8, jnp.asarray(seed, jnp.int32), cell, rate)
            np.testing.assert_array_equal(got[cell // h, cell % h, 24:32, 8:24], np.asarray(part))
        assert 0.5 * rate < 1.0 - got.mean() < 1.5 * rate


@pytest.mark.parametrize("rate", [0.0, 0.15])
def test_attention_train_matches_jax_forward_and_vjp(rate):
    """flash_attention_train forward and its VJP (the port: the autograd
    Function over the K2/K3/K4 plain versions) at N 50, which the TPU
    kernel pads to 64, with a padded key tail and a negative seed."""
    rng = np.random.default_rng(21)
    q, k, v = (rng.normal(0, 1, (2, 50, 2, 16)).astype(np.float32) for _ in range(3))
    mask = np.zeros((2, 50), bool)
    mask[0, 43:] = True
    dout = rng.normal(0, 1, q.shape).astype(np.float32)
    seed = -123456789
    ref, vjp = jax.vjp(lambda a, b_, c: j_attn.flash_attention_train(
        a, b_, c, jnp.asarray(mask), dropout_rate=rate, seed=jnp.asarray(seed, jnp.int32),
        block_q=32), jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    grads = vjp(jnp.asarray(dout))
    leaves = [_t(x).requires_grad_() for x in (q, k, v)]
    out = t_attn.flash_attention_train(*leaves, _t(mask), dropout_rate=rate, seed=seed)
    out.backward(_t(dout))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)
    for name, leaf, want in zip("qkv", leaves, grads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4,
                                   err_msg=f"d{name}")
    if rate:
        plain, _ = t_attn.attention_plain(*(_t(x) for x in (q, k, v)), _t(mask))
        assert np.abs(plain.numpy() - np.asarray(ref)).max() > 1e-2  # the mask did act


# --------------------------------------------------------- (b) K6 backward
_ROIS = np.array([
    [0, 0, 64, 64], [0, 0, 230, 230], [3.2, 7.7, 251.0, 11.1], [-5, -5, 40, 60],
    [0, 0, 256, 256], [4.0, 4.0, 4.0, 4.0], [100.5, 20.25, 140.0, 250.0],
], np.float32)
_EDGE_ROIS = np.array([[90.0, 40.0, 370.0, 52.0], [40.0, 90.0, 52.0, 370.0],
                       [300.0, 300.0, 383.0, 383.0]], np.float32)


@pytest.mark.parametrize("case", ["mixed", "clamped_multitile"])
def test_roi_align_backward_matches_jax(case):
    """Pyramid gradients through pack_pyramid to every level: the port's
    RoIAlign Function (K5 forward, K6 backward, plain here) against JAX's
    fused Pallas VJP with the f32 accumulator (interpret mode) and against
    autodiff of the XLA path. The clamped case is the regime of
    tests/test_detector.py's clamped multi-tile regression."""
    rng = np.random.default_rng(5)
    sizes, hw, rois = (((64, 32, 16, 8), (256, 256), _ROIS) if case == "mixed"
                       else ((96, 48, 24, 12), (384, 384), _EDGE_ROIS))
    bsz = 2 if case == "mixed" else 1
    feats = {k: rng.normal(0, 1, (bsz, s, s, 4)).astype(np.float32) for k, s in zip("0123", sizes)}
    boxes = np.stack([rois, rois[::-1]])[:bsz]
    cot = rng.normal(0, 1, (bsz, len(rois), 7, 7, 4)).astype(np.float32)

    def jax_grads(impl, **kw):
        def loss(fe):
            out = j_roi.multiscale_roi_align(fe, jnp.asarray(boxes), hw, impl=impl, **kw)
            return (out * jnp.asarray(cot)).sum()
        return jax.grad(loss)({k: jnp.asarray(v) for k, v in feats.items()})

    leaves = {k: _t(v).requires_grad_() for k, v in feats.items()}
    (t_roi.multiscale_roi_align(leaves, _t(boxes), hw) * _t(cot)).sum().backward()
    for want in (jax_grads("pallas", bwd_acc="f32"), jax_grads("xla")):
        for k in feats:
            np.testing.assert_allclose(leaves[k].grad.numpy(), np.asarray(want[k]), rtol=1e-4,
                                       atol=1e-5, err_msg=k)


# A RoI whose first samples lie in [-1, 0) on both axes (clamped to cell 0),
# one whose first samples lie below -1 (they add nothing), and one at the
# level's far edge, where the upper corner clamps onto the lower.
_BELOW_ZERO_ROIS = np.array([[-2.5, -2.5, 10.0, 10.0], [-9.0, -7.0, 30.0, 12.0],
                             [240.0, 200.0, 256.0, 256.0]], np.float32)


@pytest.mark.parametrize("case", ["mixed", "clamped_multitile", "below_zero"])
def test_roi_footprints_contain_every_backward_write(case):
    """K6 sums each output tile over the RoIs whose footprint meets it, and
    K5 reads each RoI's footprint window: every cell that the plain backward
    makes non-zero from a positive g lies inside its RoI's footprint
    (roi_footprints, which restates the kernels' csrc/roi_align.cuh::
    footprint), and an empty footprint goes with no write at all."""
    sizes, hw, rois = {"mixed": ((64, 32, 16, 8), (256, 256), _ROIS),
                       "clamped_multitile": ((96, 48, 24, 12), (384, 384), _EDGE_ROIS),
                       "below_zero": ((64, 32, 16, 8), (256, 256), _BELOW_ZERO_ROIS)}[case]
    feats = {k: torch.zeros(2, s, s, 4) for k, s in zip("0123", sizes)}
    packed, shapes, offsets = t_roi.pack_pyramid(feats)
    params = t_roi.roi_sample_params(_t(np.stack([rois, rois[::-1]])), shapes, offsets, hw, 7, 0)
    foot = t_roi.roi_footprints(params)
    g = torch.from_numpy(np.random.default_rng(6).uniform(0.5, 1.5, (2, len(rois), 7, 7, 4)).astype(np.float32))
    for r in range(len(rois)):
        only = torch.zeros_like(g)
        only[:, r] = g[:, r]
        touched = t_roi.roi_align_bwd_plain(only, params, tuple(packed.shape), torch.float32).ne(0).any(-1)
        for b in range(2):
            y0, y1, x0, x1 = foot[b, r].tolist()
            inside = torch.zeros_like(touched[b])
            inside[y0:y1 + 1, x0:x1 + 1] = True
            assert not (touched[b] & ~inside).any(), (case, b, r, foot[b, r])
            assert (y0 <= y1) == bool(touched[b].any()), (case, b, r)
    if case == "below_zero":  # samples in [-1, 0) read cell 0 of the RoI's level
        assert foot[0, 0, 2] == 0 and foot[0, 0, 0] == offsets[int(params["lvl"][0, 0])]


# ------------------------------------------------- (c) matcher, samplers
def test_match_proposals_matches_jax():
    """Quantised IoUs force ties (first GT wins); an invalid GT; both
    low-quality settings; batched over images."""
    rng = np.random.default_rng(8)
    iou = (rng.integers(0, 10, (2, 4, 30)) / 10.0).astype(np.float32)
    valid = np.array([[True, True, False, True], [True, False, False, False]])
    for low_quality in (False, True):
        got = t_match.match_proposals(_t(iou), _t(valid), 0.7, 0.3, low_quality)
        for i in range(2):
            want = j_match.match_proposals(jnp.asarray(iou[i]), jnp.asarray(valid[i]), 0.7, 0.3,
                                           low_quality)
            np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))


@pytest.mark.parametrize("batch_size,fraction", [(16, 0.25), (64, 0.5)])
def test_balanced_samplers_match_jax_slot_by_slot(batch_size, fraction):
    """Index and mask forms with JAX's own draws: scarce and plentiful
    positives, ignored and padded rows."""
    rng = np.random.default_rng(batch_size)
    n, bsz = 120, 3
    labels = rng.choice([-1, 0, 0, 0, 1, 2], (bsz, n))
    labels[1, :] = np.where(labels[1] > 0, 0, labels[1])  # an image without positives
    valid = rng.uniform(0, 1, (bsz, n)) > 0.1
    key = jax.random.key(batch_size)
    draws = _batched_draws(key, bsz, n)
    idx, sv = t_match.balanced_sample_idx(_t(labels), _t(valid), draws, batch_size, fraction)
    pos, neg = t_match.balanced_sample(_t(labels), _t(valid), draws, batch_size, fraction)
    j_sample_idx = jax.jit(j_match.balanced_sample_idx, static_argnums=(3, 4))
    j_sample = jax.jit(j_match.balanced_sample, static_argnums=(3, 4))
    for i, k in enumerate(jax.random.split(key, bsz)):
        j_idx, j_sv = j_sample_idx(k, jnp.asarray(labels[i]), jnp.asarray(valid[i]), batch_size, fraction)
        np.testing.assert_array_equal(sv[i].numpy(), np.asarray(j_sv))
        np.testing.assert_array_equal(idx[i].numpy()[np.asarray(j_sv)], np.asarray(j_idx)[np.asarray(j_sv)])
        j_pos, j_neg = j_sample(k, jnp.asarray(labels[i]), jnp.asarray(valid[i]), batch_size, fraction)
        np.testing.assert_array_equal(pos[i].numpy(), np.asarray(j_pos))
        np.testing.assert_array_equal(neg[i].numpy(), np.asarray(j_neg))


def test_assign_targets_to_anchors_matches_jax():
    """Anchor labels and matches over two images, one without a valid GT."""
    from transfusion_torch.models.anchors import grid_anchors
    from transfusion_torch.models.rpn import RPNConfig as TConfig, assign_targets_to_anchors as t_assign
    from transfusion_tpu.models.rpn import RPNConfig as JConfig, assign_targets_to_anchors as j_assign

    anchors = np.concatenate(grid_anchors(((16, 16), (8, 8)), (64, 64), (16, 32), (0.5, 1.0, 2.0)))
    boxes = np.array([[[4, 4, 30, 28], [20, 10, 60, 50], [0, 0, 0, 0]],
                      [[1, 1, 9, 9], [0, 0, 0, 0], [0, 0, 0, 0]]], np.float32)
    valid = np.array([[True, True, False], [False, False, False]])
    got = t_assign(_t(anchors).float(), _t(boxes), _t(valid), TConfig())
    want = j_assign(jnp.asarray(anchors), jnp.asarray(boxes), jnp.asarray(valid), JConfig())
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[0][0] == 1).any() and (got[0][1] == 0).all()


def _targets():
    boxes = np.zeros((2, 4, 4), np.float32)
    boxes[:, 0] = [10, 10, 60, 60]
    boxes[:, 1] = [80, 80, 140, 150]
    valid = np.zeros((2, 4), bool)
    valid[0, :2] = True
    valid[1, :1] = True
    return {"boxes": boxes, "nouns": np.tile([5, 9, 0, 0], (2, 1)),
            "verbs": np.tile([3, 7, 0, 0], (2, 1)),
            "ttcs": np.tile([0.5, 1.25, 0.0, 0.0], (2, 1)).astype(np.float32), "valid": valid}


def test_select_training_samples_matches_jax_slot_by_slot():
    """Sampled RoIs, triple labels (background noun 0 / verb and ttc 999,
    between-threshold -1) and regression targets, with the GT boxes
    appended and invalid proposals; JAX's draws."""
    from transfusion_torch.models.roi_heads import RoIConfig as TConfig, select_training_samples as t_sel
    from transfusion_tpu.models.roi_heads import RoIConfig as JConfig, select_training_samples as j_sel

    rng = np.random.default_rng(4)
    xy = rng.uniform(0, 120, (2, 40, 2)).astype(np.float32)
    props = np.concatenate([xy, xy + rng.uniform(8, 70, (2, 40, 2)).astype(np.float32)], -1)
    props[:, :6] = [12, 8, 58, 63]  # near the first GT: positives
    pvalid = rng.uniform(0, 1, (2, 40)) > 0.2
    tg = _targets()
    key = jax.random.key(9)
    want = jax.jit(j_sel, static_argnums=(4,))(
        key, jnp.asarray(props), jnp.asarray(pvalid), {k: jnp.asarray(v) for k, v in tg.items()},
        JConfig(batch_size_per_image=16))
    got = t_sel(_t(props), _t(pvalid), {k: _t(v) for k, v in tg.items()}, TConfig(batch_size_per_image=16),
                _batched_draws(key, 2, 44))
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        if w.dtype.kind == "f":
            np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-5, atol=1e-5, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
    assert (np.asarray(want["nouns"]) > 0).any() and (np.asarray(want["verbs"]) == 999).any()


# ------------------------------------------------------------ (c) losses
def test_losses_match_jax():
    """Every ported loss on the same rows: padding (-1), background and
    foreground labels, both verb_bg and ttc_bg settings; the RPN loss with
    JAX's draws."""
    rng = np.random.default_rng(12)
    b, s, c, v = 2, 16, 6, 5
    nouns = rng.integers(-1, c, (b, s))
    verbs = np.where(rng.uniform(0, 1, (b, s)) < 0.3, 999, rng.integers(-1, v - 1, (b, s)))
    reg = rng.normal(0, 1, (b, s, 4 * c)).astype(np.float32)
    tgt = rng.normal(0, 0.2, (b, s, 4)).astype(np.float32)
    logits = rng.normal(0, 2, (b, s, c)).astype(np.float32)
    vlogits = rng.normal(0, 2, (b, s, v)).astype(np.float32)
    ttc_p = rng.uniform(0, 3, (b, s)).astype(np.float32)
    ttc_t = rng.uniform(0, 3, (b, s)).astype(np.float32)
    nw, vw = rng.uniform(0.5, 2, c).astype(np.float32), rng.uniform(0.5, 2, v).astype(np.float32)

    def close(got, want, msg):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-7, err_msg=msg)

    x = rng.normal(0, 0.2, 50).astype(np.float32)
    np.testing.assert_allclose(t_loss.smooth_l1(_t(x), 1 / 9).numpy(),
                               np.asarray(j_loss.smooth_l1(jnp.asarray(x), 1 / 9)), rtol=1e-6)
    close(t_loss.box_loss(_t(reg), _t(nouns), _t(tgt)),
          j_loss.box_loss(jnp.asarray(reg), jnp.asarray(nouns), jnp.asarray(tgt)), "box")
    close(t_loss.noun_loss(_t(logits), _t(nouns), _t(nw)),
          j_loss.noun_loss(jnp.asarray(logits), jnp.asarray(nouns), jnp.asarray(nw)), "noun")
    for verb_bg in (True, False):
        close(t_loss.verb_loss(_t(vlogits), _t(verbs), _t(vw), verb_bg),
              j_loss.verb_loss(jnp.asarray(vlogits), jnp.asarray(verbs), jnp.asarray(vw), verb_bg),
              f"verb {verb_bg}")
    for ttc_bg in (False, True):
        close(t_loss.ttc_loss(_t(ttc_p), _t(ttc_t), _t(verbs), 2.0, ttc_bg, 0.5),
              j_loss.ttc_loss(jnp.asarray(ttc_p), jnp.asarray(ttc_t), jnp.asarray(verbs), 2.0,
                              ttc_bg, 0.5), f"ttc {ttc_bg}")
    for args in ((nw, vw, 1.0, True, True), (nw, vw, 2.0, True, False), (nw, vw, 2.0, False, True)):
        for got, want in zip(t_loss.build_class_weights(*args), j_loss.build_class_weights(*args)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)

    # RPN: 300 anchors, labels from a real assignment mix, 32 samples an image.
    a = 300
    anchors = rng.uniform(0, 80, (a, 2)).astype(np.float32)
    anchors = np.concatenate([anchors, anchors + rng.uniform(4, 40, (a, 2)).astype(np.float32)], -1)
    labels = rng.choice([-1, 0, 0, 0, 1], (b, a))
    matches = rng.integers(0, 3, (b, a))
    gt = np.concatenate([rng.uniform(0, 60, (b, 3, 2)), rng.uniform(70, 120, (b, 3, 2))], -1)
    obj = rng.normal(0, 2, (b, a)).astype(np.float32)
    deltas = rng.normal(0, 0.5, (b, a, 4)).astype(np.float32)
    key = jax.random.key(13)
    want = jax.jit(j_loss.rpn_loss, static_argnums=(7,))(
        key, jnp.asarray(obj), jnp.asarray(deltas), jnp.asarray(labels), jnp.asarray(matches),
        jnp.asarray(anchors), jnp.asarray(gt.astype(np.float32)), 32)
    got = t_loss.rpn_loss(_t(obj), _t(deltas), _t(labels), _t(matches), _t(anchors),
                          _t(gt.astype(np.float32)), 32, _batched_draws(key, b, a))
    for g, w, name in zip(got, want, ("objectness", "rpn box")):
        close(g, w, name)


# ---------------------------------------------------------- (d) optimizer
_OPT_NAMES = {  # JAX path -> port name; one parameter of each LR group
    ("rcnn", "backbone", "layer4_0", "kernel"): "backbone.body.layer4.0.conv1.weight",
    ("rcnn", "fpn", "inner_0", "kernel"): "backbone.fpn.inner_blocks.0.weight",
    ("rcnn", "predictors", "ttc_pred_layer", "kernel"): "roi_heads.ttc_pred_layer.weight",
    ("rcnn", "predictors", "noun_classifier", "bias"): "roi_heads.noun_classifier.bias",
    ("narr_encoder", "out_mlp", "kernel"): "narr_pooling_layer.out_mlp.weight",
}


def _nest(flat):
    tree = {}
    for path, val in flat.items():
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = val
    return tree


def _seven_steps(cfg, sched, accumulate=1, freeze=None):
    """make_optimizer(cfg, sched, clip 1.0, ...) of both packages over the
    same 7 gradient draws; checks the schedule and every parameter after each
    step (rtol 1e-5, atol 1e-6: the same float32 arithmetic) and returns
    (how many steps were clipped, the port's final state)."""
    from transfusion_torch.train.optim import make_optimizer as t_make, param_group_label
    from transfusion_tpu.train.optim import make_optimizer as j_make, param_group_label as j_label

    rng = np.random.default_rng(14)
    shapes = [(6, 5), (4, 3), (3, 1), (7,), (2, 8)]
    init = {path: rng.normal(0, 1, shp).astype(np.float32) for path, shp in zip(_OPT_NAMES, shapes)}
    j_mask = None if freeze is None else _nest({p: freeze[n] for p, n in _OPT_NAMES.items()})
    j_tx, j_sched = j_make(cfg, sched, steps_per_epoch=2, grad_clip=1.0, accumulate=accumulate,
                           freeze_mask=j_mask)
    t_tx, t_sched = t_make(cfg, sched, steps_per_epoch=2, grad_clip=1.0, accumulate=accumulate,
                           freeze_mask=freeze)
    for path, name in _OPT_NAMES.items():
        flat = jax.tree_util.tree_flatten_with_path(_nest({path: 0}))[0][0][0]
        assert param_group_label(name) == j_label(flat)
    j_params = _nest({p: jnp.asarray(x) for p, x in init.items()})
    j_state = j_tx.init(j_params)
    j_update = jax.jit(j_tx.update)
    t_params = {_OPT_NAMES[p]: _t(x) for p, x in init.items()}
    t_state = t_tx.init(t_params)
    clipped = 0
    for step in range(7):
        scale = 0.05 if step % 2 else 2.0
        grads = {p: (rng.normal(0, 1, x.shape) * scale).astype(np.float32) for p, x in init.items()}
        clipped += np.sqrt(sum((g ** 2).sum() for g in grads.values())) >= 1.0
        j_upd, j_state = j_update(_nest({p: jnp.asarray(g) for p, g in grads.items()}), j_state,
                                  j_params)
        j_params = jax.tree.map(lambda a, u: a + u, j_params, j_upd)
        t_upd, t_state = t_tx.update({_OPT_NAMES[p]: _t(g) for p, g in grads.items()}, t_state,
                                     t_params)
        t_params = {k: t_params[k] + t_upd[k] for k in t_params}
        np.testing.assert_allclose(float(t_sched(step)), float(j_sched(step)), rtol=1e-7)
        want = {p: np.asarray(x) for p, x in jax.tree_util.tree_flatten_with_path(j_params)[0]}
        for path, leaf in want.items():
            path = tuple(k.key for k in path)
            name = _OPT_NAMES[path]
            np.testing.assert_allclose(t_params[name].numpy(), leaf, rtol=1e-5, atol=1e-6,
                                       err_msg=f"step {step} {name}")
            if freeze is not None and freeze[name] == "frozen":
                np.testing.assert_array_equal(t_params[name].numpy(), init[path])
    return clipped, t_state


_RADAM = {"name": "radam", "lr": 2e-3, "weight_decay": 1e-2,
          "sep_encoders": {"div_rate": 4, "ttc_rate": 10}}
_MULTISTEP = {"use": True, "name": "multistep", "milestones": [1, 2], "gamma": 0.3}


def test_radam_chain_matches_optax_over_seven_steps():
    """make_optimizer(radam, weight decay, global-norm clip, sep_encoders LR
    groups, a multistep schedule) against optax over 7 steps: RAdam's
    unrectified branch (rho < 5, steps 1-5) and its rectified one, clipping
    on some steps and not others, two learning-rate drops."""
    clipped, t_state = _seven_steps(_RADAM, _MULTISTEP)
    assert 0 < clipped < 7 and t_state["count"] == 7


@pytest.mark.parametrize("case", ["adam", "adamw", "adamw-no-decay", "sgd", "sgd-no-decay",
                                  "rmsprop", "radam-accumulate-3", "adam-freeze-mask"])
def test_optimizers_match_optax_over_seven_steps(case):
    """The other optimizers of make_optimizer, gradient accumulation
    (optax.MultiSteps: the inner chain steps on calls 3 and 6) and a freeze
    mask (optax.multi_transform with set_to_zero: frozen parameters stay
    bit for bit, clipping sees the trained ones only), against optax over
    the same 7 steps as the RAdam test above."""
    name = case.split("-")[0]
    cfg = {**_RADAM, "name": name, "momentum": 0.8}
    if case.endswith("no-decay"):
        cfg["weight_decay"] = 0.0
    accumulate = 3 if "accumulate" in case else 1
    freeze = None
    if "freeze" in case:
        freeze = {n: "frozen" if i % 2 else "train" for i, n in enumerate(_OPT_NAMES.values())}
    _, t_state = _seven_steps(cfg, _MULTISTEP, accumulate, freeze)
    if accumulate > 1:
        assert t_state["gradient_step"] == 2 and t_state["mini_step"] == 1
        assert t_state["inner"]["count"] == 2


@pytest.mark.parametrize("sched", [
    {"use": True, "name": "exponential", "gamma": 0.5},
    {"use": True, "name": "warmup", "multiplier": 4.0, "total_epoch": 2,
     "after_warmup": "multistep", "milestones": [1], "gamma": 0.1},
    {"use": True, "name": "warmup", "multiplier": 2.0, "total_epoch": 1,
     "after_warmup": "exponential", "gamma": 0.5},
    None,
])
def test_epoch_schedules_match_jax(sched):
    from transfusion_torch.train.optim import make_epoch_schedule as t_sched
    from transfusion_tpu.train.optim import make_epoch_schedule as j_sched

    t, j = t_sched(sched, 3e-4, 3), j_sched(sched, 3e-4, 3)
    for step in range(14):
        np.testing.assert_allclose(float(t(step)), float(j(step)), rtol=1e-6, err_msg=str(step))
