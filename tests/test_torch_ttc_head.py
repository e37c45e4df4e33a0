"""The port's transformer TTC head and its host side against the JAX
package's, on the CPU: ``TTCPredictionHead`` with and without encoder
layers (outputs, and parameter gradients against ``jax.grad``), ``predict_ttc`` on fixed
detections in eval and in training, ``ttc_hand_loss`` (value and gradient
against ``jax.grad``), the FrankMocap hand-history lookup on a pickle and
the GloVe narration embedder on a 4-d table written here (bit for bit),
then, on the port alone, a tiny train step on the TTC loss alone, which
reaches the head and nothing upstream of its detached inputs.

JAX parameters reach the port through ``weights.state_dict_from_jax``.
Tolerances: f32 outputs at rtol 1e-5 / atol 1e-6, gradients within 1e-5
of their largest entry; the loss at 1e-6.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_threads import cap_torch_threads  # noqa: F401
from transfusion_torch import weights as W
from transfusion_torch.models import ttc_head as T
from transfusion_tpu.models import ttc_head as J

HEAD = dict(feat_dim=32, ff_dim=48, num_heads=2, num_steps=3, emb_steps_hand=20,
            emb_steps_object=30, object_feat_dim=24, max_len=64, dropout=0.1)


def _t(x):
    return torch.from_numpy(np.array(x))


def _inputs(n=5, seed=0):
    rng = np.random.default_rng(seed)
    s = HEAD["num_steps"]
    boxes = np.sort(rng.uniform(0, 1, (n, 2 * s, 4)), -1).astype(np.float32)
    boxes[1, 2:] = 0.0  # missing detections are zero-filled
    return {"box_features": rng.normal(0, 1, (n, HEAD["object_feat_dim"])).astype(np.float32),
            "object_boxes": np.sort(rng.uniform(0, 1, (n, 1, 4)), -1).astype(np.float32),
            "hand_boxes": boxes,
            "hand_poses": rng.normal(0, 1, (n, 2 * s, 63)).astype(np.float32)}


def _head_state(params) -> dict:
    out: dict = {}
    W._ttc_head(jax.device_get(params), out)
    return {k.removeprefix("ttc_hand_head."): _t(np.asarray(v, np.float32)) for k, v in out.items()}


def _pair(num_layers):
    cfg = dict(HEAD, num_layers=num_layers)
    jhead = J.TTCPredictionHead(J.TTCHeadConfig(**cfg))
    inputs = _inputs()
    params = jax.device_get(jhead.init(jax.random.key(num_layers), inputs))["params"]
    port = T.TTCPredictionHead(T.TTCHeadConfig(**cfg))
    port.load_state_dict(_head_state(params), strict=True)
    return jhead, params, port.eval(), inputs


@pytest.mark.parametrize("num_layers", [2, 0])
def test_ttc_head_matches_jax(num_layers):
    """The softplus TTC of each detection, and the parameter gradients of
    <ttc, cotangent> through jax.vjp against autograd."""
    jhead, params, port, inputs = _pair(num_layers)
    assert T.TTCHeadConfig(**HEAD).num_tokens == 1 + 4 + 4 * 6 + 6
    def apply(p):
        return jhead.apply({"params": p}, inputs)

    want = jax.jit(apply)(params)
    got = port({k: _t(v) for k, v in inputs.items()})
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    cot = np.random.default_rng(3).normal(0, 1, want.shape).astype(np.float32)
    jgrads = jax.jit(jax.grad(lambda p: jnp.sum(apply(p) * cot)))(params)
    (got * _t(cot)).sum().backward()
    grads = _head_state(jgrads)
    assert set(grads) == {k for k, _ in port.named_parameters()}
    for k, p in port.named_parameters():
        w = grads[k].numpy()
        err = np.abs(p.grad.numpy() - w).max()
        assert err <= 1e-5 * max(float(np.abs(w).max()), 1e-6), (k, err)


def test_ttc_hand_loss_matches_jax():
    """NaN targets, invalid detections and negative placeholders drop out;
    an image with none left contributes nothing; the value and the
    gradient in the predictions."""
    from transfusion_torch.train.losses import ttc_hand_loss as t_loss
    from transfusion_tpu.train.losses import ttc_hand_loss as j_loss

    rng = np.random.default_rng(4)
    preds = rng.uniform(0, 3, (4, 5)).astype(np.float32)
    preds[0, 1] = -1.0
    valid = rng.uniform(0, 1, (4, 5)) > 0.3
    gt = rng.uniform(0.2, 2, (4, 3)).astype(np.float32)
    gt[2, 0] = np.nan
    for beta in (1.0, 2.0):
        want, grad = jax.value_and_grad(lambda p: j_loss(p, valid, gt, beta))(jnp.asarray(preds))
        tp = _t(preds).requires_grad_()
        got = t_loss(tp, _t(valid), _t(gt), beta)
        got.backward()
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(tp.grad.numpy(), np.asarray(grad), rtol=1e-6, atol=1e-7)
    zero = t_loss(_t(preds), torch.zeros(4, 5, dtype=torch.bool), _t(gt), 1.0)
    assert zero.item() == 0.0


def _model_cfgs(ttc_num_layers=1):
    """The golden tiny model with the transformer TTC head, in both packages."""
    import dataclasses

    from tests.test_torch_fusion_options import _cfg

    head = dict(HEAD, object_feat_dim=64, num_layers=ttc_num_layers, dropout=0.0)
    cfgs = []
    for pkg, mod in (("tpu", J), ("torch", T)):
        cfg = _cfg(pkg, {}, ttc_hand=mod.TTCHeadConfig(**head), max_ttc_boxes=3)
        roi = dataclasses.replace(cfg.detector.roi, ttc_hand=True)
        cfgs.append(dataclasses.replace(cfg, detector=dataclasses.replace(cfg.detector, roi=roi)))
    return cfgs


def _train_batch():
    from tests.test_torch_fusion_options import _batch

    rng = np.random.default_rng(9)
    s = HEAD["num_steps"]
    batch = {k: v for k, v in _batch(64, 64).items() if k != "visual_features"}
    batch.update(hand_boxes=np.sort(rng.uniform(0, 1, (2, 2 * s, 4)), -1).astype(np.float32),
                 hand_poses=rng.normal(0, 1, (2, 2 * s, 63)).astype(np.float32),
                 targets={"boxes": np.array([[[8.0, 8.0, 40.0, 44.0]]] * 2, np.float32),
                          "nouns": np.full((2, 1), 2), "verbs": np.full((2, 1), 1),
                          "ttcs": np.full((2, 1), 0.9, np.float32), "valid": np.ones((2, 1), bool)})
    return batch


@pytest.fixture(scope="module")
def ttc_model():
    """The tiny TTC model's JAX param shapes (eval_shape of the training
    init, which creates the head: no compile), filled from a seed, and the
    port with them."""
    from tests.test_torch_language_paths import fill
    from transfusion_torch.models.transfusion import TransFusion as TModel
    from transfusion_tpu.models.transfusion import TransFusion as JModel

    jcfg, tcfg = _model_cfgs()
    jmodel = JModel(jcfg)
    batch = dict(jax.tree.map(jnp.asarray, _train_batch()), image_hw=(64, 64))
    keys = {"params": jax.random.key(0), "sampling": jax.random.key(1), "dropout": jax.random.key(2)}
    params = fill(jax.eval_shape(lambda k: jmodel.init(k, batch, True), keys)["params"], 8)
    port = TModel(tcfg, device="cpu")
    port.load_state_dict(W.state_dict_from_jax(params), strict=True)
    return jmodel, params, port, tcfg


def _fixed_dets(seed=6, b=2, k=10, r=32):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 60, (b, k, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(4, 40, (b, k, 2))], -1).astype(np.float32)
    valid = rng.uniform(0, 1, (b, k)) > 0.25
    return {"boxes": boxes, "scores": rng.uniform(0, 1, (b, k)).astype(np.float32),
            "nouns": rng.integers(1, 7, (b, k)).astype(np.int32),
            "verbs": rng.integers(0, 5, (b, k)).astype(np.int32),
            "ttcs": np.where(valid, -1.0, 0.0).astype(np.float32),
            "prop_idx": rng.integers(0, r, (b, k)).astype(np.int32), "valid": valid}


@pytest.mark.parametrize("training", [False, True])
def test_predict_ttc_matches_jax(ttc_model, training):
    """The head's pass over the first max_ttc_boxes detections of fixed
    detections (the reference's second softplus; the MIN_TTC clamp in eval
    only) against model.apply(..., method="predict_ttc")."""
    jmodel, params, port, _ = ttc_model
    rng = np.random.default_rng(7)
    dets = _fixed_dets()
    roi = {"box_features": rng.normal(0, 1, (2, 32, 64)).astype(np.float32)}
    s = HEAD["num_steps"]
    batch = {"hand_boxes": np.sort(rng.uniform(0, 1, (2, 2 * s, 4)), -1).astype(np.float32),
             "hand_poses": rng.normal(0, 1, (2, 2 * s, 63)).astype(np.float32)}
    hw = (96, 128)
    want = jmodel.apply({"params": params}, jax.tree.map(jnp.asarray, dets), roi, batch, hw, training,
                        method="predict_ttc")
    port.train(training)
    with torch.no_grad():
        got = port.predict_ttc({k: _t(v) for k, v in dets.items()}, {k: _t(v) for k, v in roi.items()},
                               {k: _t(v) for k, v in batch.items()}, hw, training=training)
    port.eval()
    assert set(got) == set(want)
    np.testing.assert_allclose(got["ttcs"].numpy(), np.asarray(want["ttcs"]), rtol=1e-5, atol=1e-6)
    for k in ("boxes", "scores", "nouns", "verbs", "prop_idx", "valid"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    clamped = (np.asarray(want["ttcs"])[:, :3][dets["valid"][:, :3]] >= 0.251).all()
    assert clamped or training


def test_ttc_train_step_trains_the_head_only(ttc_model):
    """One port train step on the TTC loss alone (the other criterion
    weights 0): every head parameter gets gradient and no trunk parameter
    does, since the head reads detached box features."""
    from transfusion_torch.train.optim import make_optimizer
    from transfusion_torch.train.step import LossConfig, TrainState, make_train_step

    _, _, port, cfg = ttc_model
    raw = _train_batch()
    batch = {k: _t(v) for k, v in raw.items() if k != "targets"}
    batch.update(input_ids=batch["input_ids"].long(), image_hw=(64, 64),
                 targets={k: _t(v) for k, v in raw["targets"].items()})
    saved = {k: v.clone() for k, v in port.state_dict().items()}
    tx, _ = make_optimizer({"name": "radam", "lr": 1e-4}, None, 10)
    state = TrainState(0, tx.init(dict(port.named_parameters())), seed=3)
    step = make_train_step(port, tx, LossConfig(ttc_on=True), torch.ones(7), torch.ones(5))
    m = step(state, batch, np.array([0, 0, 0, 0, 1, 0], np.float32))
    grads = {k: p.grad for k, p in port.named_parameters()}
    port.load_state_dict(saved)
    port.eval()
    assert m["nonfinite_skipped"] == 0.0 and m["ttc_loss"].item() > 0.0
    head = [k for k in grads if k.startswith("ttc_hand_head.")]
    assert head and all(grads[k] is not None and grads[k].any() for k in head)
    leaked = [k for k, g in grads.items() if not k.startswith("ttc_hand_head.") and g is not None and g.any()]
    assert not leaked, leaked


# ------------------------------------------------------------- host side
def _frankmocap_cache(path):
    """{video: {frame: record}} with both hands, one hand, an empty record
    and a frame with two people (skipped)."""
    rng = np.random.default_rng(11)

    def hand():
        return {"pred_joints_img": rng.uniform(0, 300, (21, 3)).astype(np.float32)}

    def record(sides, people=1):
        bbox = {s: rng.uniform(10, 200, 4).astype(np.float32) for s in sides}
        return {"image_width": 456, "image_height": 256, "hand_bbox_list": [bbox] * people,
                "pred_output_list": [{s: hand() for s in sides}] * people}

    cache = {"vid-0000": {100: record(("left_hand", "right_hand")), 95: record(("right_hand",)),
                          90: {}, 85: record(("left_hand", "right_hand"), people=2),
                          0: record(("left_hand",))},
             "vid-0001": {7: record(("left_hand", "right_hand"))}}
    with open(path, "wb") as fp:
        pickle.dump(cache, fp)


def test_hand_pose_lookup_matches_jax(tmp_path):
    from transfusion_torch.data.hand_pose import HandPoseLookup as TLookup
    from transfusion_torch.data.hand_pose import ZeroHandLookup
    from transfusion_tpu.data.hand_pose import HandPoseLookup as JLookup

    path = str(tmp_path / "hands.pkl")
    _frankmocap_cache(path)
    for steps, stride in ((5, 5), (3, 50)):
        ours, ref = TLookup(path, steps, stride), JLookup(path, steps, stride)
        for video, frame in (("vid-0000", 100), ("vid-0000", 12), ("vid-0001", 7), ("missing", 3)):
            for a, b in zip(ours.get(video, frame), ref.get(video, frame)):
                assert a.dtype == b.dtype and a.shape == b.shape
                np.testing.assert_array_equal(a, b)
        assert ours.get("vid-0000", 100)[0].any()
    # Without a cache: the zeros JAX's lookup gives a video it lacks (the
    # JAX trainer's _ZeroHandLookup builds the same arrays).
    for a, b in zip(ZeroHandLookup(4).get("x", 1), JLookup(path, 4).get("missing", 1)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype and not a.any()


def test_glove_embedder_matches_jax(tmp_path, monkeypatch):
    from transfusion_torch.data.glove import GloveNarrationEmbedder as TGlove
    from transfusion_torch.data.glove import load_glove_table as t_load
    from transfusion_tpu.data.glove import GloveNarrationEmbedder as JGlove
    from transfusion_tpu.data.glove import load_glove_table as j_load

    rng = np.random.default_rng(12)
    words = ["take", "knife", "cut", "onion", "zucchini", "cloth", "zero"]
    lines = [f"{w} " + " ".join(f"{v:.6f}" for v in rng.normal(0, 1, 4)) for w in words[:-1]]
    lines.append("zero 0 0 0 0")
    (tmp_path / "glove.6B.4d.txt").write_text("\n".join(lines) + "\n\n")
    path = str(tmp_path / "glove.6B.4d.txt")
    for normalize in (True, False):
        a, b = t_load(path, normalize), j_load(path, normalize)
        assert set(a) == set(b) and "courgette" in a
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    texts = ["take knife, cut onion", "cut courgette", "unknown words only", "", "indument zero"]
    for pooling in ("max", "mean"):
        ours = TGlove(path, size=4, pooling=pooling)
        ref = JGlove(path, size=4, pooling=pooling)
        for text in texts:
            x, y = ours(text), ref(text)
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError):
        TGlove(path, size=4, pooling="sum")
    monkeypatch.setenv("DATA", str(tmp_path))
    assert TGlove.from_env(size=4) is not None and TGlove.from_env(size=300) is None
