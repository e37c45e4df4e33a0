"""The port's data parallelism on the CPU (``transfusion_torch/parallel``,
the trainer and the CLI), its ranks as gloo processes on ``localhost``
(``tests/torch_parallel_workers.py``):
  * the mesh helpers and the FSDP rule against the JAX package's
    ``param_shardings``;
  * draws keyed by the global image index: a rank's dropout masks, sampler
    keys and attention-dropout cells are the one-rank run's for its images;
  * the slice as a whole: a 2-rank port train step with trainable BN
    (replicated, then fully sharded) against JAX's ``make_train_step`` on a
    2-device data mesh (the conftest's forced host devices, compiled at
    XLA's lowest backend optimisation level), with JAX's draws;
  * port only: 2 ranks (DP and FSDP) against 1 rank over an epoch
    (training, sharded evaluation, checkpoint), the 2-rank checkpoint
    resumed at 1 rank, and ``--devices 2 --device cpu`` through the CLI.

Tolerances. Against JAX, as ``test_torch_train_step.py``: losses at rtol
1e-4, every parameter's update at 1e-3 of its largest update (or two f32
ulps of the parameter) plus rtol 1e-3, running averages at 1e-5 of their
largest entry. 2 ranks against 1 over an epoch (2 steps; the model in
float64 on both sides, as the tensor-parallel tests' f64 runs, so that the
sums over the ranks in another order round far below the tolerance, which
in f32 the tiny random-weight model amplified to 1.6e-4 at two threads):
the training losses at rtol 1e-4, mAP at rtol 1e-5, and every update, running average and
optimizer moment within 2e-2 of the one-rank tensor in relative L2 norm
with the median over tensors of the largest entry's error within 1e-3: a
ReLU whose input lies within rounding of zero flips between the runs and
moves single gradient entries of the trunk by a whole cotangent (up to 11 %
of a tensor's largest update after 4 steps, 2e-4 typically). Both ranks
hold the same parameters bit for bit.
"""

import concurrent.futures
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_parallel_workers as wk
from tests.test_torch_trainer import cli_env  # noqa: F401  (fixture)
from tests.torch_threads import cap_torch_threads  # noqa: F401
from transfusion_torch.weights import state_dict_from_jax


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-12)
    assert float(np.abs(got - want).max()) <= tol * scale, what


def _updates_close(after, want, before, what):
    """new - old of every parameter, as test_torch_train_step.py holds it."""
    for n, b in before.items():
        du_t = (after[n] - b).numpy()
        du_w = (want[n] - b).numpy()
        scale = float(np.abs(du_w).max())
        ulp2 = 2.4e-7 * float(b.abs().max())
        np.testing.assert_allclose(du_t, du_w, rtol=1e-3, atol=max(1e-3 * scale, ulp2, 1e-10),
                                   err_msg=f"{what} {n}")


def _drift_close(pairs, what):
    """An epoch's drift: each (got, want) tensor within 2e-2 of ``want`` in
    relative L2 norm, and the median over tensors of the largest entry's
    error within 1e-3 of that tensor's largest entry."""
    worst = []
    for name, got, want in pairs:
        got, want = got.double(), want.double()
        err = (got - want).norm() / want.norm().clamp(min=1e-30)
        assert err <= 2e-2, (what, name, float(err))
        worst.append(float((got - want).abs().max() / want.abs().max().clamp(min=1e-30)))
    assert np.median(worst) <= 1e-3, (what, np.median(worst))


def test_mesh_helpers_without_a_process_group():
    from transfusion_torch.parallel import mesh

    assert (mesh.world_size(), mesh.rank()) == (1, 0)
    assert mesh.make_mesh().shape == {"data": 1, "model": 1}
    assert mesh.make_mesh(devices=["a", "b"]).shape == {"data": 2, "model": 1}
    assert mesh.make_mesh(model=2, devices=["a", "b"]).shape == {"data": 1, "model": 2}
    with pytest.raises(ValueError, match="mesh 0x2 != 1 devices"):
        mesh.make_mesh(model=2)
    assert [mesh.round_to_data_axis(b, 4) for b in (1, 4, 5, 8)] == [4, 4, 8, 8]
    batch = {"image": np.arange(8).reshape(4, 2), "image_hw": (3, 5),
             "targets": {"boxes": torch.arange(4)}}
    part = mesh.shard_batch(batch, 1, 2)
    assert part["image"].tolist() == [[4, 5], [6, 7]] and part["image_hw"] == (3, 5)
    assert part["targets"]["boxes"].tolist() == [2, 3]
    with pytest.raises(ValueError):
        mesh.shard_batch({"image": np.zeros((3, 1))}, 0, 2)
    assert mesh.allgather_pyobj({"a": 1}) == [{"a": 1}]
    t = torch.ones(3)
    assert mesh.global_sum(t) is t and mesh.batch_rows(4) == (0, 4, 4)


def test_fsdp_rule_matches_jax_param_shardings():
    """The port's rule gives the dimension JAX's ``param_shardings`` shards
    over a 2-way data axis, shape for shape, and replicates without fsdp."""
    from transfusion_torch.parallel.mesh import param_shardings as t_rule
    from transfusion_tpu.parallel.mesh import make_mesh, param_shardings as j_rule

    shapes = {"bias": (3,), "wide": (256, 512), "tall": (1000, 70), "odd": (3, 3, 63, 129),
              "small": (255, 257), "cube": (4, 128, 128), "conv": (2048, 512, 1, 1)}
    jmesh = make_mesh(data=2, model=1, devices=jax.devices()[:2])
    tree = {k: np.zeros(s, np.float32) for k, s in shapes.items()}
    for fsdp in (True, False):
        j = j_rule(jmesh, tree, fsdp=fsdp)
        t = t_rule(shapes.items(), 2, fsdp=fsdp)
        for k in shapes:
            spec = tuple(j[k].spec)
            want = spec.index("data") if "data" in spec else None
            assert t[k].data == want and t[k].model is None, (k, fsdp, t[k], spec)
    assert all(p.data is None for p in t_rule(shapes.items(), 1, fsdp=True).values())


def test_draws_follow_the_global_image_index():
    """A rank holding images 2-3 of 4 draws the dropout keep masks (f32 and
    bf16, one and several rows an image), the sampler keys and the
    attention-dropout mask the one-rank run draws for those images; the
    CUDA kernels' seed fold of the batch offset gives the same hash."""
    from transfusion_torch.models.text_encoder import DropoutRNG
    from transfusion_torch.ops import attention as at
    from transfusion_torch.ops.matcher import uniform_draws

    for dtype in (torch.float32, torch.bfloat16):
        for shape in ((4, 5, 6), (12, 7)):
            x = torch.randn(shape).to(dtype)
            per = shape[0] // 4
            whole = DropoutRNG("cpu", 3, 5, (0, 4, 4)).keep(x, 0.15)
            part = DropoutRNG("cpu", 3, 5, (2, 4, 4)).keep(x[2 * per:], 0.15)
            assert torch.equal(part, whole[2 * per:]), (dtype, shape)
    gen = lambda: torch.Generator().manual_seed(9)  # noqa: E731
    whole = uniform_draws((4, 11), gen())
    part = uniform_draws((2, 11), gen(), rows=(2, 4, 4))
    assert all(torch.equal(p, w[2:]) for p, w in zip(part, whole))
    seed, nh, n = 1234567, 3, 40
    want = at.dropout_keep_mask(4, nh, n, seed, 0.2, "cpu")[2:]
    assert torch.equal(at.dropout_keep_mask(2, nh, n, seed, 0.2, "cpu", batch_offset=2), want)
    folded = at._dropout_args(0.2, seed, batch_offset=2, nh=nh)[0]
    assert torch.equal(at.dropout_keep_mask(2, nh, n, folded, 0.2, "cpu"), want)
    q, k, v = (torch.randn(4, n, nh, 8) for _ in range(3))
    out, _ = at.attention_plain(q, k, v, None, 0.2, seed)
    got, _ = at.attention_plain(q[2:], k[2:], v[2:], None, 0.2, seed, batch_offset=2)
    assert torch.equal(got, out[2:])


def _jax_pair():
    """The tiny model of test_torch_train_step.py with trainable BN: JAX's
    2-device step lowered on sharded inputs, and what the ranks need."""
    import dataclasses

    from tests.test_torch_train_step import (B, CRITERION, H, MODEL_CFG, OPT_CFG, SCHED_CFG, W,
                                             _batch, _configs, _jax_draws, _to_torch)
    from transfusion_torch.models.transfusion import TransFusion as TModel
    from transfusion_torch.runner.trainer import backbone_stop_grad_stages, unfreeze_multipliers
    from transfusion_torch.train.step import criterion_weights
    from transfusion_tpu.models.transfusion import TransFusion as JModel
    from transfusion_tpu.parallel.mesh import make_mesh, replicated, shard_batch
    from transfusion_tpu.runner.trainer import unfreeze_multipliers as j_mult
    from transfusion_tpu.train.losses import build_class_weights as j_weights
    from transfusion_tpu.train.optim import make_optimizer as j_opt
    from transfusion_tpu.train.step import LossConfig as JLoss, TrainState as JState
    from transfusion_tpu.train.step import make_train_step as j_step
    from tests.test_torch_trainable_bn import _fill

    def live_bn(cfg):
        return dataclasses.replace(cfg, detector=dataclasses.replace(cfg.detector, trainable_bn=True))

    jcfg, tcfg = (live_bn(c) for c in _configs(backbone_stop_grad_stages(0, MODEL_CFG)))
    jmodel = JModel(jcfg)
    batch = _batch()
    jbatch = jax.tree.map(jnp.asarray, batch)
    shapes = jax.eval_shape(lambda r: jmodel.init({"params": r}, dict(jbatch, image_hw=(H, W)), False),
                            jax.random.key(0))
    tree = _fill(shapes, 21)
    jtx, _ = j_opt(OPT_CFG, SCHED_CFG, steps_per_epoch=1, grad_clip=4.0)
    nw, vw = np.linspace(0.5, 1.5, 7), np.linspace(0.7, 1.3, 5)
    loss_kw = dict(ttc_on=True, lm_on=True, rpn_batch_size_per_image=16, last_noun_idx=6)
    jmesh = make_mesh(data=2, model=1, devices=jax.devices()[:2])
    rep = replicated(jmesh)
    params = jax.device_put(tree["params"], rep)
    state = JState(step=jax.device_put(jnp.asarray(0), rep), params=params,
                   opt_state=jax.device_put(jtx.init(tree["params"]), rep),
                   batch_stats=jax.device_put(tree["batch_stats"], rep))
    jb = shard_batch(jmesh, jbatch)
    mult = jax.device_put(j_mult(shapes["params"], 0, MODEL_CFG, 0, 1, 2), rep)
    lw = criterion_weights(CRITERION)
    rng = jax.random.key(7)
    jstep = j_step(jmodel, jtx, JLoss(**loss_kw), *j_weights(nw, vw, 1.0, True, True), donate=False)
    lowered = jstep.lower(state, jb, rng, jnp.asarray(lw), (H, W), mult)
    pool = concurrent.futures.ThreadPoolExecutor(1)
    compiled = pool.submit(lowered.compile, {"xla_backend_optimization_level": 0})
    pool.shutdown(wait=False)

    port = TModel(tcfg, device="cpu")
    port.load_state_dict(state_dict_from_jax(tree["params"], batch_stats=tree["batch_stats"]),
                         strict=True)
    tbatch = dict(_to_torch(batch), image_hw=(H, W))
    with torch.no_grad():
        anchors = port.eval()(tbatch)["proposals"]["anchors"].shape[0]
    draws = _jax_draws({"jmodel": jmodel, "jstate": state, "jcfg": jcfg, "jbatch": jbatch,
                        "_anchors": anchors}, 0, rng)
    assert B == 2
    payload = {"tcfg": tcfg, "params": tree["params"], "batch_stats": tree["batch_stats"],
               "opt": OPT_CFG, "sched": SCHED_CFG, "loss_kw": loss_kw, "class_w": (nw, vw),
               "batch": tbatch, "loss_w": lw, "draws": draws, "fsdp_min_size": 2 ** 16,
               "mult": unfreeze_multipliers(port.named_parameters(), 0, MODEL_CFG, 0, 1, 2)}
    run = lambda: compiled.result()(state, jb, rng, jnp.asarray(lw), mult)  # noqa: E731
    before = {k: v.detach().clone() for k, v in port.named_parameters()}
    return run, payload, before


def test_two_rank_trainable_bn_step_matches_jax_two_device_mesh(tmp_path):
    """One train step of the tiny model with trainable BN on 2 ranks, one
    image each, replicated and then fully sharded (its optimizer on shards):
    the losses, every parameter's update and the running averages match
    JAX's step on a 2-device data mesh, where XLA reduces the statistics and
    gradients over the global batch."""
    run, payload, before = _jax_pair()
    wk.spawn(wk.jax_step_rank, 2, payload, str(tmp_path))
    jstate, jm = run()
    want = state_dict_from_jax(jax.device_get(jstate.params),
                               batch_stats=jax.device_get(jstate.batch_stats))
    assert float(jm["nonfinite_skipped"]) == 0.0
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2)]
    for mode in ("dp", "fsdp"):
        got = ranks[0][mode]
        assert (got["sharded"] == 0) if mode == "dp" else (got["sharded"] > 10)
        for k, v in got["model"].items():
            assert torch.equal(v, ranks[1][mode]["model"][k]), (mode, k)
        assert got["metrics"]["nonfinite_skipped"] == 0.0
        for key in ("loss", "bbox_loss", "objectness_loss", "loss_rpn_box_reg", "noun_loss",
                    "verb_loss", "ttc_loss", "lm_loss"):
            np.testing.assert_allclose(got["metrics"][key], float(jm[key]), rtol=1e-4, atol=1e-6,
                                       err_msg=f"{mode} {key}")
        _updates_close(got["model"], want, before, mode)
        stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
        assert len(stats) == 2 * 17
        for k in stats:
            _close(got["model"][k], want[k], 1e-5, f"{mode} {k}")


def test_two_ranks_match_one_rank_over_an_epoch(tmp_path):
    """fit(1) of the tiny trainable-BN config (dropout on, clipping on, a
    short padded validation batch) at 2 ranks, data-parallel and fully
    sharded, against 1 rank: the same losses, parameters, running averages,
    optimizer state, mAP and result JSON; rank 0 alone writes; FSDP holds
    part of the moments a rank; the 2-rank FSDP checkpoint resumed at 1 rank
    gives its state bit for bit and its evaluation. Every run keeps 64
    test-time proposals an image (``torch_parallel_workers.few_proposals``)
    and computes in float64."""
    wk.spawn(wk.fit_rank, 2, str(tmp_path))
    fresh = wk._tp_trainer(wk.tiny_run_config(), str(tmp_path / "one"), device="cpu",
                           data=wk.tiny_data(), f64=True)
    fresh.ensure_state()
    before = {k: v.detach().clone() for k, v in fresh.model.named_parameters()}
    fresh.fit(1)
    one = wk.trainer_record(fresh)
    total = sum(v.numel() for v in one["opt_state"]["mu"].values())
    rec = one["history"][0]
    assert rec["train_steps"] == wk.N_TRAIN // 4 and rec["train_nonfinite_skipped"] == 0.0
    for mode in ("dp", "fsdp"):
        ranks = [torch.load(tmp_path / mode / f"rank{r}.pt", weights_only=False) for r in range(2)]
        got = ranks[0]
        for k, v in got["model"].items():
            assert torch.equal(v, ranks[1]["model"][k]), (mode, k)
        h = got["history"][0]
        timed = ("train_time", "train_s_per", "train_decode")
        assert ({k: v for k, v in h.items() if not k.startswith(timed)}
                == {k: v for k, v in ranks[1]["history"][0].items() if not k.startswith(timed)})
        for k, v in rec.items():
            # Host timings differ; the validation losses too, since the short
            # last batch is padded to the 2 ranks (1 -> 2 images, rank 1 holding
            # only the pad), as JAX pads.
            if k.startswith((*timed, "val_")):
                continue
            np.testing.assert_allclose(h[k], v, rtol=1e-4, atol=1e-7, err_msg=f"{mode} {k}")
        _drift_close([(k, got["model"][k] - b, one["model"][k] - b) for k, b in before.items()],
                     f"{mode} updates")
        _drift_close([(k, got["model"][k], v) for k, v in one["model"].items()
                      if k.endswith(("running_mean", "running_var"))], f"{mode} running averages")
        for m in ("mu", "nu"):
            _drift_close([(k, got["opt_state"][m][k], v) for k, v in one["opt_state"][m].items()],
                         f"{mode} {m}")
        assert set(got["results"]["results"]) == set(one["results"]["results"])
        for uid, dets in one["results"]["results"].items():
            mine = got["results"]["results"][uid]
            assert len(mine) == len(dets), (mode, uid)
            for a, b in zip(mine, dets):
                np.testing.assert_allclose(a["box"], b["box"], rtol=1e-4, atol=1e-3)
                np.testing.assert_allclose(a["score"], b["score"], rtol=1e-4, atol=1e-6)
        lines = open(tmp_path / mode / "history.jsonl").read().splitlines()
        assert len(lines) == 1
        local = got["local_opt_numel"]
        assert (local == total) if mode == "dp" else (local < 0.75 * total)

    ckpt = str(tmp_path / "fsdp" / "checkpoints" / "epoch_0000")
    back = wk._tp_trainer(wk.tiny_run_config(), str(tmp_path / "resumed"), device="cpu",
                          data=wk.tiny_data(), f64=True)
    back.ensure_state(resume_from=ckpt)
    got = torch.load(tmp_path / "fsdp" / "rank0.pt", weights_only=False)
    for k, v in back.model.state_dict().items():
        assert torch.equal(v, got["model"][k]), k
    for m in ("mu", "nu"):
        for k, v in back.state.opt_state[m].items():
            assert torch.equal(v, got["opt_state"][m][k]), (m, k)
    res = back.evaluate(0)
    for k, v in got["history"][0].items():
        if k.startswith("map_"):
            np.testing.assert_allclose(res.metrics[k], v, rtol=1e-5, atol=1e-7, err_msg=k)
    assert json.load(open(res.result_json_path))["results"].keys() == got["results"]["results"].keys()


def test_cli_devices_2_on_the_cpu(cli_env, tmp_path):  # noqa: F811
    """``--devices 2 --device cpu`` runs two gloo ranks through the CLI:
    one epoch on the synthetic dataset with validation, the challenge JSON,
    one checkpoint and one history line, written once."""
    from transfusion_torch.runner.run_experiment import main

    run_dir = str(tmp_path / "two")
    main(["--config", cli_env["config"], "--device", "cpu", "--devices", "2", "--run-dir", run_dir,
          "--epochs", "1"])
    history = [json.loads(line) for line in open(os.path.join(run_dir, "history.jsonl"))]
    assert len(history) == 1
    rec = history[0]
    assert rec["train_steps"] == 2 and rec["train_nonfinite_skipped"] == 0.0
    assert np.isfinite(rec["train_loss"]) and 0.0 <= rec["map_box_noun_verb_val"] <= 100.0
    payload = json.load(open(os.path.join(run_dir, "results", "val_epoch0.json")))
    assert len(payload["results"]) == 4
    assert os.path.isfile(os.path.join(run_dir, "checkpoints", "epoch_0000", "state.pt"))
    assert os.path.isfile(os.path.join(run_dir, "run.log"))
    assert os.path.isfile(os.path.join(run_dir, "run.rank1.log"))
