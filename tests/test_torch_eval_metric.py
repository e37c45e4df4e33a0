"""The port's evaluation against the JAX package's, on the CPU: the eval
step with validation losses (``make_eval_loss_step``: one trunk, the eval
RoI branch and the sampled loss branch) on the golden tiny model's weights,
the Ego4D STA mAP and the challenge-JSON export.

The eval-loss step: both packages take the golden tiny model's JAX
parameters (``tests/test_torch_slice.py::golden``, carried into the port by
``state_dict_from_jax``), the same batch with targets, and the same sampler
draws (the test regenerates the JAX step's ``jax.random.uniform`` arrays:
the RoI sampler's key from ``key(0)`` as flax hands it to the detector,
split per image then per class; the RPN sampler's from ``key(1)``, split
per image then per class). The JAX step is compiled at XLA's lowest backend
optimisation level (the same arithmetic, less compile time). Tolerances:
detections at the golden test's rtol 1e-4 / atol 1e-3 with integer slots
exact; every loss at rtol 1e-4 / atol 1e-6 (an f32 forward through the
whole model in another order). The metric and the export are the same
numpy arithmetic in both packages: exact.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_slice import FREQS, _port_cfg, golden  # noqa: F401  (the fixture)
from tests.torch_threads import cap_torch_threads  # noqa: F401

LOSS_KW = dict(ttc_on=True, rpn_batch_size_per_image=16, last_noun_idx=6)
CRITERION = {"bbox": 1, "obj_prop": 1, "noun": 1, "verb": 1, "ttc": 0.5}
TARGETS = {"boxes": np.array([[[30, 20, 70, 50], [80, 55, 115, 85]]], np.float32),
           "nouns": np.array([[2, 5]], np.int32), "verbs": np.array([[1, 3]], np.int32),
           "ttcs": np.array([[0.5, 1.5]], np.float32), "valid": np.array([[True, True]])}


def _jax_draws(model, params, n_roi: int, n_anchor: int, bsz: int):
    """The uniform keys of the JAX eval-loss step: (RoI pos, RoI neg) from
    the detector's first 'sampling' key under key(0), (RPN pos, RPN neg)
    under key(1)."""
    k_roi = model.apply({"params": params}, method=lambda m: m.rcnn.make_rng("sampling"),
                        rngs={"sampling": jax.random.key(0)})

    def per_image(key, n):
        kp, kn = jax.random.split(key)
        return jax.random.uniform(kp, (n,)), jax.random.uniform(kn, (n,))

    roi = jax.vmap(lambda k: per_image(k, n_roi))(jax.random.split(k_roi, bsz))
    rpn = jax.vmap(lambda k: per_image(k, n_anchor))(jax.random.split(jax.random.key(1), bsz))
    as_t = lambda pair: tuple(torch.from_numpy(np.array(x)) for x in pair)  # noqa: E731
    return {"roi": as_t(roi), "rpn": as_t(rpn)}


def test_eval_loss_step_matches_jax(golden):  # noqa: F811
    """One JAX make_eval_loss_step against the port's: detections slot by
    slot, the validation total and every per-term loss; the port's
    make_eval_step gives the same detections, apply_rpn_roi(sample=True)
    the same loss branch."""
    from transfusion_torch.train.losses import build_class_weights as t_weights
    from transfusion_torch.train.step import LossConfig as TLoss
    from transfusion_torch.train.step import make_eval_loss_step as t_step
    from transfusion_torch.train.step import make_eval_step as t_eval_step
    from transfusion_torch.train.step import normalized_criterion_weights
    from transfusion_tpu.train.losses import build_class_weights as j_weights
    from transfusion_tpu.train.step import LossConfig as JLoss
    from transfusion_tpu.train.step import make_eval_loss_step as j_step

    nw, vw = np.linspace(0.5, 1.5, 7), np.linspace(0.7, 1.3, 4)
    lw = normalized_criterion_weights(CRITERION)
    hw = golden["hw"]
    jbatch = dict(golden["batch"], targets=jax.tree.map(jnp.asarray, TARGETS))
    jstep = j_step(golden["model"], golden["cfg"].detector, JLoss(**LOSS_KW),
                   *j_weights(nw, vw, 1.0, True, True), noun_verb_frequencies=jnp.asarray(FREQS))
    compiled = jstep.lower(golden["params"]["params"], jbatch, jnp.asarray(lw), hw).compile(
        {"xla_backend_optimization_level": 0})
    jdets, jm = jax.device_get(compiled(golden["params"]["params"], jbatch, jnp.asarray(lw)))

    port = golden["port"]
    tbatch = dict(golden["tbatch"], targets={
        k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
        for k, v in TARGETS.items()})
    with torch.no_grad():
        out = port.eval_with_losses(tbatch)
    n_roi = out["loss"]["proposals"]["boxes"].shape[1] + TARGETS["boxes"].shape[1]
    n_anchor = out["loss"]["proposals"]["anchors"].shape[0]
    draws = _jax_draws(golden["model"], golden["params"]["params"], n_roi, n_anchor, 1)
    step = t_step(port, _port_cfg().detector, TLoss(**LOSS_KW),
                  *t_weights(nw, vw, 1.0, True, True), noun_verb_frequencies=FREQS)
    dets, tm = step(tbatch, lw, draws)

    assert set(dets) == set(jdets)
    assert np.asarray(jdets["valid"]).any()
    for key, want in jdets.items():
        got, want = dets[key].numpy(), np.asarray(want)
        assert got.shape == want.shape, key
        if want.dtype.kind == "f":
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3, err_msg=key)
        else:
            np.testing.assert_array_equal(got, want, err_msg=key)
    assert set(tm) == set(jm)
    for key in jm:
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-4, atol=1e-6,
                                   err_msg=key)
    assert float(jm["noun_loss"]) > 0 and float(jm["objectness_loss"]) > 0
    # Fixed generators: a second call draws the same keys and gives the same bits.
    again_dets, again = step(tbatch, lw)
    first_dets, first = step(tbatch, lw)
    for key in first:
        assert torch.equal(first[key], again[key]), key
    for key in first_dets:
        assert torch.equal(first_dets[key], again_dets[key]), key
    # make_eval_step: the eval forward alone gives the same detections bit
    # for bit (its proposals are the eval branch's).
    eval_dets = t_eval_step(port, _port_cfg().detector, noun_verb_frequencies=FREQS)(golden["tbatch"])
    assert set(eval_dets) == set(dets)
    for key in dets:
        assert torch.equal(eval_dets[key], dets[key]), key
    # The loss branch, which takes the eval branch's proposals, equals
    # apply_rpn_roi(sample=True) on the same trunk bit for bit.
    with torch.no_grad():
        branch = port.eval_with_losses(tbatch, draws=draws["roi"])["loss"]
        whole = port.apply_rpn_roi(port.trunk(tbatch), tbatch["image_hw"], tbatch["targets"],
                                   draws=draws["roi"], sample=True)
    flat = lambda out: torch.utils._pytree.tree_flatten(out)[0]  # noqa: E731
    assert len(flat(branch)) == len(flat(whole))
    for a, b in zip(flat(branch), flat(whole)):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b


def _sta_case(seed: int):
    """Per-image (preds, labels) with near matches: boxes around IoU 0.5 of a
    GT box, TTCs either side of the 0.25 threshold, tied scores, images with
    no predictions and images with no labels."""
    rng = np.random.default_rng(seed)
    pairs = []
    for i in range(12):
        ng = int(rng.integers(0, 4)) if i % 5 else 0
        gt = np.concatenate([rng.uniform(0, 300, (ng, 2)), rng.uniform(320, 600, (ng, 2))], 1)
        labels = {"boxes": np.floor(gt), "nouns": rng.integers(1, 5, ng),
                  "verbs": rng.integers(0, 4, ng), "ttcs": rng.uniform(0.2, 2.0, ng)}
        n_pred = 0 if i % 4 == 1 else int(rng.integers(1, 9))
        boxes = []
        for j in range(n_pred):
            if ng and j % 2 == 0:
                g = gt[j % ng]
                shrink = rng.choice([0.0, 0.28, 0.29, 0.3, 0.45])  # IoU about 1, 0.5, or lower
                w = g[2] - g[0]
                boxes.append([g[0] + shrink * w, g[1], g[2], g[3]])
            else:
                x, y = rng.uniform(0, 500, 2)
                boxes.append([x, y, x + rng.uniform(10, 200), y + rng.uniform(10, 200)])
        scores = np.round(rng.uniform(0, 1, n_pred), 1)  # ties
        ttcs = np.array([labels["ttcs"][j % ng] + rng.choice([-0.26, -0.24, 0.0, 0.25, 0.3])
                         if ng else 1.0 for j in range(n_pred)])
        preds = {"boxes": np.floor(np.asarray(boxes, np.float64).reshape(-1, 4)), "scores": scores,
                 "nouns": np.array([labels["nouns"][j % ng] if ng and j % 3 else rng.integers(1, 5)
                                    for j in range(n_pred)], np.int64),
                 "verbs": rng.integers(0, 4, n_pred), "ttcs": ttcs}
        pairs.append((preds, labels))
    return pairs


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("variant", ["sta", "no_ttc", "all_classes"])
def test_sta_map_matches_jax(seed, variant):
    """The 8 STA measures (5 without TTC; every class counted) of the port's
    numpy matcher equal JAX's on the same images, near matches, ties and
    empty images included."""
    from transfusion_torch.metrics import sta_map as t_sta
    from transfusion_tpu.metrics import sta_map as j_sta

    kinds = {"sta": ("STAMeanAveragePrecision", {}),
             "no_ttc": ("STAMeanAveragePrecisionNoTTC", {}),
             "all_classes": ("STAMeanAveragePrecision", {"count_all_classes": True, "top_k": 3})}
    name, kw = kinds[variant]
    got, want = getattr(t_sta, name)(**kw), getattr(j_sta, name)(**kw)
    for preds, labels in _sta_case(seed):
        got.add(preds, labels)
        want.add(preds, labels)
    a, b = got.evaluate(), want.evaluate()
    assert got.get_short_names() == want.get_short_names() and len(a) == len(b)
    np.testing.assert_array_equal(np.array(a), np.array(b))
    assert any(0.0 < v < 100.0 for v in a), a
    boxes = _sta_case(seed)[2][0]["boxes"]
    np.testing.assert_array_equal(t_sta.iou_plus_one(boxes, boxes[::-1]),
                                  j_sta.iou_plus_one(boxes, boxes[::-1]))


def test_export_matches_jax(tmp_path):
    """detections_to_results (original-resolution boxes, the noun
    background swap undone, top 5 of the valid slots), write_result_json and
    fuse_result_jsons write JAX's JSON."""
    from transfusion_torch.runner import export as t_exp
    from transfusion_tpu.runner import export as j_exp

    rng = np.random.default_rng(4)
    b, k = 3, 8
    dets = {"boxes": rng.uniform(0, 300, (b, k, 4)).astype(np.float32),
            "scores": rng.uniform(0, 1, (b, k)).astype(np.float32),
            "nouns": rng.integers(0, 7, (b, k)), "verbs": rng.integers(0, 5, (b, k)),
            "ttcs": rng.uniform(0, 2, (b, k)).astype(np.float32),
            "valid": rng.uniform(0, 1, (b, k)) > 0.3}
    dets["valid"][2] = False  # an image with no detection
    dets["nouns"][0, :3] = 6  # the background-swapped last noun
    uids, orig = ["a", "b", "c"], np.array([[1080, 1440], [540, 720], [768, 1024]])
    got = t_exp.detections_to_results(dets, uids, orig, (96, 128), last_noun_idx=6)
    want = j_exp.detections_to_results(dets, uids, orig, (96, 128), last_noun_idx=6)
    assert got == want and got["c"] == [] and any(e["noun_category_id"] == 0 for e in got["a"])
    paths = []
    for pkg, name in ((t_exp, "t"), (j_exp, "j")):
        p1 = pkg.write_result_json({u: got[u] for u in uids[:2]}, str(tmp_path / name / "1.json"), 3)
        p2 = pkg.write_result_json({"c": got["c"], "a": got["b"]}, str(tmp_path / name / "2.json"))
        paths.append((p1, pkg.fuse_result_jsons([p1, p2], str(tmp_path / name / "fused.json"))))
    (t1, tf), (j1, jf) = paths
    assert open(t1).read() == open(j1).read() and open(tf).read() == open(jf).read()
    fused = json.load(open(tf))
    assert set(fused["results"]) == {"a", "b", "c"} and fused["results"]["a"] == got["b"]
