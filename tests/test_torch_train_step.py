"""The port's train step against the JAX package's ``make_train_step`` on the
CPU, in f32, on a tiny model (ResNet stages (1, 1, 1, 1), fusion at FPN
level 2 with 2x2 patches of 32-dim tokens, a 2-layer BERT, the LM head on
the fused language tokens with its loss in the criterion) with every
dropout rate 0. One fusion level keeps the one JAX compile short; the
levels share their code, and test_torch_slice.py holds all four.

Both packages start from the same JAX-initialised parameters (through
``weights.state_dict_from_jax``) and the same optimizer state, take the same
batch, the same ``update_mult`` (the trainer's epoch rules, here with layers
2-4 of the body and the last BERT layer training) and the same sampler
draws: the test regenerates the exact ``jax.random.uniform`` arrays of the
JAX step's key chain (fold_in(rng, step), split in 3; the RoI sampler's key
as flax hands it to the detector, split per image, then per class; the RPN
sampler's split per image, then per class) and passes them to the port.

Tolerances: the losses at rtol 1e-4 (f32 forward through the whole model);
every parameter's update (new - old) at 1e-3 of that tensor's largest
update (or two f32 ulps of the parameter, which new - old carries, or
1e-10 for gradients that are zero in exact arithmetic) plus rtol 1e-3,
because gradients of a deep f32 stack computed in another order agree to
about 1e-5 relative and the first RAdam step passes the (clipped)
gradient through unnormalised. One JAX train step is compiled
once for the module, from shapes alone, in a thread while the fixture
builds the port.
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transfusion_torch.weights import radam_state_from_jax, state_dict_from_jax

H, W, B = 96, 128, 2
MODEL_CFG = {"type": "res50", "train_ep": 0, "trainable_layers": 3}
OPT_CFG = {"name": "radam", "lr": 1e-3, "weight_decay": 1e-4,
           "sep_encoders": {"div_rate": 4, "ttc_rate": 10}}
SCHED_CFG = {"use": True, "name": "multistep", "milestones": [1], "gamma": 0.5}
CRITERION = {"bbox": 1, "obj_prop": 1, "noun": 1, "verb": 1, "ttc": 0.5, "lm": 1}


def _configs(stop_grad: int):
    """(JAX config, port config) of the same tiny model, dropout off."""
    from transfusion_torch.models import detector as td, roi_heads as tr, rpn as trpn
    from transfusion_torch.models import text_encoder as tt, transfusion as ttf
    from transfusion_tpu.models import detector as jd, roi_heads as jr, rpn as jrpn
    from transfusion_tpu.models import text_encoder as jt, transfusion as jtf

    def build(det, roi, rpn, txt, tf):
        return tf.TransFusionConfig(
            detector=det.DetectorConfig(
                roi=roi.RoIConfig(num_nouns=7, num_verbs=5, representation_size=64,
                                  batch_size_per_image=16, detections_per_img=10, ttc_on=True),
                rpn=rpn.RPNConfig(pre_nms_top_n_train=64, post_nms_top_n_train=32),
                stage_sizes=(1, 1, 1, 1), stop_grad_stages=stop_grad),
            fusion=tf.FusionConfig(fpn_features=(2,), patch_h=(2,), patch_w=(2,),
                                   num_layers=(1,), token_dim=32, num_heads=2,
                                   token_dropout=0.0, patch_dropout=0.0, backproj_dropout=0.0),
            bert=txt.BertConfig(vocab_size=64, hidden_size=16, num_layers=2, num_heads=2,
                                intermediate_size=32, max_position_embeddings=16, dropout=0.0),
            out_mlp=32, out_dropout=0.0, lm_on=True)

    return build(jd, jr, jrpn, jt, jtf), build(td, tr, trpn, tt, ttf)


def _batch():
    rng = np.random.default_rng(11)
    boxes = np.array([[[10, 12, 60, 70], [70, 20, 120, 90]],
                      [[5, 5, 50, 40], [0, 0, 0, 0]]], np.float32)
    mask = np.ones((B, 8), np.int32)
    mask[1, 6:] = 0
    return {
        "image": rng.normal(0.3, 0.5, (B, H, W, 3)).astype(np.float32),
        "input_ids": rng.integers(0, 64, (B, 8)).astype(np.int32),
        "attention_mask": mask,
        "targets": {"boxes": boxes, "nouns": np.array([[2, 5], [1, 0]]),
                    "verbs": np.array([[1, 3], [999, 0]]),
                    "ttcs": np.array([[0.5, 1.5], [0.9, 0.0]], np.float32),
                    "valid": np.array([[True, True], [True, False]])},
    }


def _to_torch(x):
    if isinstance(x, dict):
        return {k: _to_torch(v) for k, v in x.items()}
    t = torch.from_numpy(np.array(x))
    return t.long() if t.dtype == torch.int32 else t


@pytest.fixture(scope="module")
def pair():
    from transfusion_torch.models.transfusion import TransFusion as TModel
    from transfusion_torch.runner.trainer import backbone_stop_grad_stages
    from transfusion_torch.train.losses import build_class_weights as t_weights
    from transfusion_torch.train.optim import make_optimizer as t_opt
    from transfusion_torch.train.step import LossConfig as TLoss, TrainState, make_train_step as t_step
    from transfusion_tpu.models.transfusion import TransFusion as JModel
    from transfusion_tpu.runner.trainer import unfreeze_multipliers as j_mult
    from transfusion_tpu.train.losses import build_class_weights as j_weights
    from transfusion_tpu.train.optim import make_optimizer as j_opt
    from transfusion_tpu.tools.translate_checkpoint import translate_reference_checkpoint
    from transfusion_tpu.train.step import LossConfig as JLoss, TrainState as TrainState_j
    from transfusion_tpu.train.step import make_train_step as j_step
    from transfusion_torch.weights import init_random_

    stop_grad = backbone_stop_grad_stages(0, MODEL_CFG)
    jcfg, tcfg = _configs(stop_grad)
    jmodel = JModel(jcfg)
    batch = _batch()
    jbatch = jax.tree.map(jnp.asarray, batch)
    shapes = jax.eval_shape(lambda r: jmodel.init({"params": r}, dict(jbatch, image_hw=(H, W)), False),
                            jax.random.key(0))["params"]
    jtx, _ = j_opt(OPT_CFG, SCHED_CFG, steps_per_epoch=1, grad_clip=4.0)
    mult = j_mult(shapes, 0, MODEL_CFG, 0, 1, 2)
    nw, vw = np.linspace(0.5, 1.5, 7), np.linspace(0.7, 1.3, 5)
    loss_kw = dict(ttc_on=True, lm_on=True, rpn_batch_size_per_image=16, last_noun_idx=6)
    jstep = j_step(jmodel, jtx, JLoss(**loss_kw), *j_weights(nw, vw, 1.0, True, True), donate=False)
    # The one JAX program of the module, lowered from shapes alone and
    # compiled (at XLA's lowest backend optimisation level: the same
    # arithmetic, a third less compile time) in a thread while the rest of
    # the fixture and the first test run.
    abstract = TrainState_j(step=jax.eval_shape(lambda: jnp.asarray(0)), params=shapes,
                            opt_state=jax.eval_shape(jtx.init, shapes))
    lowered = jstep.lower(abstract, jbatch, jax.random.key(7), jnp.zeros(6), (H, W), mult)
    pool = concurrent.futures.ThreadPoolExecutor(1)
    compiled = pool.submit(lowered.compile, {"xla_backend_optimization_level": 0})
    pool.shutdown(wait=False)  # the thread ends with the compile
    # Seeded port weights carried into the JAX tree by the reference
    # translator (its round trip is pinned in test_torch_slice.py): no JAX
    # init program to compile.
    port = init_random_(TModel(tcfg, device="cpu"), seed=5)
    tree, report = translate_reference_checkpoint(
        port.state_dict(), jax.tree.map(lambda x: np.zeros(x.shape, x.dtype), shapes),
        fpn_features=(2,), patch_hw=((2, 2),))
    assert report["translated"] == len(jax.tree.leaves(shapes))
    jparams = jax.tree.map(jnp.asarray, tree)
    port.load_state_dict(state_dict_from_jax(tree), strict=True)
    state = TrainState_j(step=jnp.asarray(0), params=jparams, opt_state=jtx.init(jparams))

    ttx, _ = t_opt(OPT_CFG, SCHED_CFG, steps_per_epoch=1, grad_clip=4.0)
    params = dict(port.named_parameters())
    tstate = TrainState(step=0, opt_state=ttx.init(params))
    tstep = t_step(port, ttx, TLoss(**loss_kw), *t_weights(nw, vw, 1.0, True, True))
    return {"jmodel": jmodel, "jstate": state, "jstep": compiled, "jbatch": jbatch, "mult": mult,
            "port": port, "tstate": tstate, "tstep": tstep,
            "tbatch": dict(_to_torch(batch), image_hw=(H, W)),
            "jcfg": jcfg}


def _jax_draws(p, step: int, rng):
    """The uniform keys the JAX step draws at ``step``: (RoI pos, RoI neg),
    (RPN pos, RPN neg)."""
    r_sampling, _, r_rpn = jax.random.split(jax.random.fold_in(rng, step), 3)
    k_roi = p["jmodel"].apply({"params": p["jstate"].params},
                              method=lambda m: m.rcnn.make_rng("sampling"),
                              rngs={"sampling": r_sampling})
    cfg = p["jcfg"].detector
    n_roi = cfg.rpn.post_nms_top_n_train + p["jbatch"]["targets"]["boxes"].shape[1]
    n_anchor = int(p["_anchors"])

    def per_image(key, n):
        kp, kn = jax.random.split(key)
        return jax.random.uniform(kp, (n,)), jax.random.uniform(kn, (n,))

    roi = jax.vmap(lambda k: per_image(k, n_roi))(jax.random.split(k_roi, B))
    rpn = jax.vmap(lambda k: per_image(k, n_anchor))(jax.random.split(r_rpn, B))
    as_t = lambda pair: tuple(torch.from_numpy(np.array(x)) for x in pair)  # noqa: E731
    return {"roi": as_t(roi), "rpn": as_t(rpn)}


def _t_mult(p):
    from transfusion_torch.runner.trainer import unfreeze_multipliers

    return unfreeze_multipliers(p["port"].named_parameters(), 0, MODEL_CFG, 0, 1, 2)


def test_unfreeze_multipliers_match_jax(pair):
    """The trainer's epoch rules over the port's names give the JAX tree's
    multipliers leaf for leaf (mapped through state_dict_from_jax), for
    several epochs and rule sets."""
    from transfusion_torch.runner.trainer import unfreeze_multipliers as t_mult
    from transfusion_tpu.runner.trainer import unfreeze_multipliers as j_mult

    names = [n for n, _ in pair["port"].named_parameters()]
    cases = [(0, {"train_ep": -1, "trainable_layers": 2}, -1, 1, -1),
             (0, MODEL_CFG, 0, 1, -1),
             (3, {"train_ep": 2, "trainable_layers": 5}, 1, 2, -1),
             (1, {"train_ep": 0, "trainable_layers": 1}, 0, 1, 1)]
    for epoch, mcfg, narr_ep, finetune, freeze_at in cases:
        tree = j_mult(pair["jstate"].params, epoch, mcfg, narr_ep, finetune, 2, freeze_at)
        want = state_dict_from_jax(jax.tree.map(lambda m, x: np.full(x.shape, m, np.float32),
                                                tree, pair["jstate"].params))
        got = t_mult(pair["port"].named_parameters(), epoch, mcfg, narr_ep, finetune, 2, freeze_at)
        assert set(got) == set(names)
        for n in names:
            vals = np.unique(want[n].numpy())
            assert len(vals) == 1 and vals[0] == got[n], (epoch, mcfg, n, vals, got[n])


def test_train_steps_match_jax(pair):
    """One train step: losses and every parameter's update match the JAX
    step's, and the JAX optimizer state after it, carried over with
    radam_state_from_jax, equals the port's own. (Later steps only repeat
    the RAdam chain and the schedules, which test_torch_train_ops.py holds
    against optax over seven steps.)"""
    from transfusion_torch.train.step import criterion_weights

    rng = jax.random.key(7)
    lw = criterion_weights(CRITERION)
    mult = _t_mult(pair)
    names = [n for n, _ in pair["port"].named_parameters()]
    before = {n: p.detach().clone() for n, p in pair["port"].named_parameters()}
    with torch.no_grad():
        out = pair["port"].eval()(pair["tbatch"])
    pair["_anchors"] = out["proposals"]["anchors"].shape[0]
    draws = _jax_draws(pair, 0, rng)
    jstate, jm = pair["jstep"].result()(pair["jstate"], pair["jbatch"], rng, jnp.asarray(lw),
                                        pair["mult"])
    tm = pair["tstep"](pair["tstate"], pair["tbatch"], lw, mult, draws)
    assert tm["nonfinite_skipped"] == 0.0 and float(jm["nonfinite_skipped"]) == 0.0
    for key in ("loss", "bbox_loss", "objectness_loss", "loss_rpn_box_reg", "noun_loss",
                "verb_loss", "ttc_loss", "lm_loss"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-4, atol=1e-6,
                                   err_msg=key)
    want = state_dict_from_jax(jax.device_get(jstate.params))
    moved = 0
    for n, p in pair["port"].named_parameters():
        du_t = (p.detach() - before[n]).numpy()
        du_j = (want[n] - before[n]).numpy()
        scale = float(np.abs(du_j).max())
        # An update is read as new - old, which carries the rounding of the
        # f32 parameter: allow two ulps of the parameter's magnitude.
        # The floor 1e-10 covers gradients that are zero in exact
        # arithmetic (the attention key bias) and come out as 1e-14 noise.
        ulp2 = 2.4e-7 * float(before[n].abs().max())
        np.testing.assert_allclose(du_t, du_j, rtol=1e-3, atol=max(1e-3 * scale, ulp2, 1e-10),
                                   err_msg=n)
        if mult[n] == 0.0:
            assert scale == 0.0, n
        moved += scale > 0
    assert moved > len(names) // 2
    carried = radam_state_from_jax(jax.device_get(jstate.opt_state), names)
    assert carried["count"] == pair["tstate"].opt_state["count"] == 1
    for key, floor in (("mu", 1e-9), ("nu", 1e-15)):  # zero-gradient noise, as above
        for n in names:
            got = pair["tstate"].opt_state[key][n].numpy()
            ref = carried[key][n].numpy()
            np.testing.assert_allclose(got, ref, rtol=1e-3,
                                       atol=max(1e-3 * float(np.abs(ref).max()), floor),
                                       err_msg=f"{key} {n}")
