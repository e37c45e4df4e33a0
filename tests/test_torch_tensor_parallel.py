"""The port's model axis (tensor parallelism, ``parallel/tensor_parallel.py``)
against the JAX package's rule and against the one-rank run, on the CPU.

Without processes: the port's ``param_shardings`` against JAX's on a
(data 4, model 2) mesh of the conftest's host devices, element by element
through ``weights.state_dict_from_jax`` (each JAX leaf filled with its
shard indices; ``jax.eval_shape`` only, nothing compiled), for the golden
tiny model, the five fusion families of chip_smoke.py's phase 7 and the
three of phase 8 at tiny widths (``tp_min_dim`` 16, as JAX's
tests/test_mesh_trainer.py lowers it), and at ``tp_min_dim`` 256 on the
flagship's widths (depth and vocabulary cut); a whole state sharded and
joined again; the dropout keep masks of a split tensor.

Processes (gloo on ``localhost``, spawned by tests/torch_parallel_workers.py,
which imports no JAX): one group of 2 ranks on a (1, 2) mesh runs the
golden tiny eval, ``fit(1)`` of the tiny trainable-BN config with dropout
and clipping on (in f32, and in f64), and a resume of a one-rank
checkpoint; one group of 4 ranks on a (2, 2) mesh with FSDP runs
``fit(1)`` in f64; both against the one-rank ``fit(1)`` run here
meanwhile. Then the CLI's ``--devices 2
--mesh-model 2``. The one-rank step itself is held against JAX's
``make_train_step`` by tests/test_torch_train_step.py.

Tolerances: detections as tests/test_torch_slice.py (rtol 1e-4 / atol
1e-3, integers exact); losses 1e-5 relative; dropout masks and checkpoints
bit for bit; in f64 each parameter's update, running average and moment
1e-4 relative L2 (the moments are f32: 1.0e-5 seen at 2 x 2). In f32 this tiny random-weight model turns rounding into
update gaps of up to 1e-2 on near-cancelling BatchNorm gradients (one rank
at 1 and at 8 threads differ up to 2.3e-4, median 1.8e-6; model 2 against
one rank up to 1.3e-2, median 7e-5), so the f32 run is held on its draws,
losses and evaluation, and the updates in f64 (model 2 against one rank
there: 2.6e-7 at most).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_parallel_workers as wk
from tests.test_golden_detections import GOLDEN, _fixed_batch, _tiny_model
from tests.test_torch_fusion_options import FAMILIES, _batch, _cfg
from tests.test_torch_language_paths import TTC_HEAD, _family
from tests.test_torch_slice import FREQS, _port_cfg
from tests.test_torch_trainer import cli_env  # noqa: F401  (fixture)
from tests.test_runner_cli import RUN_CFG
from tests.torch_threads import cap_torch_threads  # noqa: F401
from transfusion_torch.parallel import mesh as M
from transfusion_torch.parallel import tensor_parallel as tp
from transfusion_torch.weights import shard_state_dict, state_dict_from_jax

DATA, MODEL = 4, 2


# ------------------------------------------------------------- the rule
def _tree_config(name: str):
    """(JAX TransFusionConfig, batch) of a tiny configuration: the golden
    model with one phase 7-8 configuration's change."""
    if name == "flagship":
        return _cfg("tpu", {}), _batch(64, 64)
    if name in FAMILIES:
        fusion, top = FAMILIES[name]
        return _cfg("tpu", fusion, **top), _batch(64, 64)
    if name in ("gpt2", "flan_t5_large"):
        return _family("tpu", "gpt2" if name == "gpt2" else "t5"), _batch(64, 64)
    import dataclasses

    from transfusion_tpu.models.ttc_head import TTCHeadConfig

    cfg = _cfg("tpu", {}, max_ttc_boxes=3)
    roi = dataclasses.replace(cfg.detector.roi, ttc_hand=True)
    cfg = dataclasses.replace(cfg, ttc_hand=TTCHeadConfig(**TTC_HEAD),
                              detector=dataclasses.replace(cfg.detector, roi=roi))
    batch = _batch(64, 64)
    rng = np.random.default_rng(3)
    s = TTC_HEAD["num_steps"]
    batch["hand_boxes"] = np.sort(rng.uniform(0, 1, (2, 2 * s, 4)), -1).astype(np.float32)
    batch["hand_poses"] = rng.normal(0, 1, (2, 2 * s, 63)).astype(np.float32)
    return cfg, batch


def _flagship_widths():
    """The flagship's widths (896-dim fusion tokens in 4 heads, MiniLM-L12's
    384 in 12 heads and 1,536, the 1,280-wide box head on 12,544 pooled
    features, ResNet-50), at depth 1 a stage, two fusion levels (2 and 3,
    patches 2 and 1) of one layer, one MiniLM layer and a 64-token vocab."""
    import dataclasses

    from transfusion_tpu.models.text_encoder import BertConfig

    cfg = _cfg("tpu", {"token_dim": 896, "num_heads": 4})
    roi = dataclasses.replace(cfg.detector.roi, representation_size=1280)
    return dataclasses.replace(
        cfg, detector=dataclasses.replace(cfg.detector, roi=roi), out_mlp=896,
        bert=BertConfig(vocab_size=64, num_layers=1)), _batch(64, 64)


def _jax_shapes(cfg, batch):
    from transfusion_tpu.models.transfusion import TransFusion as JModel

    jmodel = JModel(cfg)
    batch = jax.tree.map(jnp.asarray, batch)
    if not cfg.use_visual_features:
        batch.pop("visual_features")
    return jax.eval_shape(lambda k: jmodel.init({"params": k}, dict(batch, image_hw=(64, 64)),
                                                False), jax.random.key(0))["params"]


def _shard_codes(shapes, fsdp_min_size: int, tp_min_dim: int):
    """JAX's ``param_shardings`` on a (4, 2) mesh, as a tree of arrays: each
    element 1 + its model shard + 8 x its data shard."""
    from transfusion_tpu.parallel.mesh import make_mesh, param_shardings

    jmesh = make_mesh(data=DATA, model=MODEL, devices=jax.devices()[:DATA * MODEL])
    specs = param_shardings(jmesh, shapes, fsdp=True, fsdp_min_size=fsdp_min_size,
                            tp_min_dim=tp_min_dim)

    def codes(s, sh):
        v = np.ones(s.shape, np.float32)
        for d, axis in enumerate(tuple(sh.spec)):
            if axis is None:
                continue
            n, scale = (MODEL, 1) if axis == "model" else (DATA, 8)
            idx = np.arange(s.shape[d]) // (s.shape[d] // n) * scale
            v = v + idx.reshape([-1 if i == d else 1 for i in range(v.ndim)]).astype(np.float32)
        return v

    return jax.tree.map(codes, shapes, specs)


def _varies_along(a: np.ndarray) -> set:
    return {d for d in range(a.ndim) if a.shape[d] > 1 and not (np.diff(a, axis=d) == 0).all()}


def _check_rule(shapes, fsdp_min_size: int, tp_min_dim: int) -> int:
    """The port's rule against JAX's, tensor by tensor; returns how many
    tensors the model axis splits."""
    coded = state_dict_from_jax(_shard_codes(shapes, fsdp_min_size, tp_min_dim))
    place = M.param_shardings(((k, v.shape) for k, v in coded.items()), DATA, fsdp=True,
                              fsdp_min_size=fsdp_min_size, model=MODEL, tp_min_dim=tp_min_dim)
    split = 0
    for name, v in coded.items():
        v = v.numpy().astype(np.int64) - 1
        model_idx, data_idx = v % 8, v // 8
        p = place[name]
        assert _varies_along(data_idx) == ({p.data} if p.data is not None else set()), (name, p)
        want = torch.zeros(v.shape, dtype=torch.int64)
        if p.model is not None:
            split += 1
            piece = list(v.shape)
            piece[p.model] //= MODEL
            want = tp.join([torch.full(piece, r) for r in range(MODEL)], p.model, p.parts)
        if name.endswith("bias") and p.model is not None:
            # A column layer's bias: JAX keeps it whole (XLA slices it under
            # jit); the port splits it with its kernel's output dimension.
            assert (model_idx == 0).all(), name
            assert place[name[:-len("bias")] + "weight"].model == 0, name
            continue
        np.testing.assert_array_equal(model_idx, want.numpy(), err_msg=name)
    return split


@pytest.mark.parametrize("name", ["flagship", "lm", "shared_sum_sep", "asymmetric", "space_time",
                                  "vis_lang", "gpt2", "flan_t5_large", "ttc_hand"])
def test_model_axis_rule_matches_jax_param_shardings(name):
    """Every parameter of the tiny configuration is split where JAX's
    ``param_shardings`` splits it, element for element on the model axis
    (the packed q/k/v split kernel by kernel) and on the same dimension of
    the data axis (FSDP), at ``tp_min_dim`` 16."""
    split = _check_rule(_jax_shapes(*_tree_config(name)), fsdp_min_size=2 ** 10, tp_min_dim=16)
    assert split > 0


def test_model_axis_rule_at_flagship_widths():
    """At ``tp_min_dim`` 256 and the flagship's widths the fusion layers,
    MiniLM, the back-projections and the box head split as JAX splits
    them; the 64-wide heads and the predictors stay whole."""
    shapes = _flagship_widths()
    split = _check_rule(_jax_shapes(*shapes), fsdp_min_size=2 ** 16, tp_min_dim=256)
    # 2 fusion layers x (q/k/v, its bias, out_proj, linear1, its bias, linear2),
    # 2 back_proj, MiniLM's 1 layer x (3 + 3 biases + output, intermediate +
    # bias + output), fc6 + bias, fc7.
    assert split == 2 * 6 + 2 + 10 + 3


def test_shard_state_dict_then_join_returns_the_whole_state():
    """The golden tiny model's whole state cut for model ranks 0 and 1 of a
    (1, 2) mesh (``tp_min_dim`` 16) and joined again, as a checkpoint
    gathers it: bit for bit; the split tensors halve."""
    from transfusion_torch.models.transfusion import TransFusion
    from transfusion_torch.weights import init_random_

    sd = init_random_(TransFusion(_port_cfg(), device="cpu"), seed=3).state_dict()
    mesh = M.Mesh(1, 2)
    parts = [shard_state_dict(sd, mesh, 16, model_rank=r) for r in range(2)]
    place = M.param_shardings(((k, v.shape) for k, v in sd.items()), 1, model=2, tp_min_dim=16)
    n_split = 0
    for k, v in sd.items():
        p = place[k]
        if p.model is None:
            assert all(part[k] is v for part in parts), k
            continue
        n_split += 1
        assert parts[0][k].numel() * 2 == v.numel(), k
        assert torch.equal(tp.join([part[k] for part in parts], p.model, p.parts), v), k
    assert n_split == 27
    assert shard_state_dict(sd, M.Mesh(2, 1)) is sd


def test_an_axis_that_splits_an_attention_head_raises():
    """At model 8 the JAX rule still splits the golden model's 32-wide
    fusion kernels, which would split its 2 heads: NotImplementedError
    names the layer, before any parameter is cut."""
    from transfusion_torch.models.transfusion import TransFusion

    model = TransFusion(_port_cfg(), device="cpu")
    split = tp.tensor_parallel_for({k: p.shape for k, p in model.named_parameters()}, M.Mesh(1, 8),
                                   16, rank=0)
    assert split.split
    with pytest.raises(NotImplementedError, match="splits its 2 attention heads"):
        tp.shard_model_(model, split)
    assert model.tensor_parallel is None
    assert all(p.shape == split.whole_shapes[k] for k, p in model.named_parameters())


@pytest.mark.parametrize("device_rows", [None, (2, 4, 6)])
def test_dropout_of_a_split_tensor_keeps_its_part_of_the_whole_mask(device_rows):
    """A rank's keep mask of its heads (dim 1) or hidden columns (dim -1) is
    its part of the mask one rank draws for the whole tensor, bit for bit,
    also under a data axis (images 2-3 of 6)."""
    from transfusion_torch.models.text_encoder import DropoutRNG

    g = torch.Generator().manual_seed(5)
    for shape, dim in (((6, 4, 7, 7), 1), ((6, 9, 8), -1)):
        x = torch.randn(shape, generator=g)
        whole = DropoutRNG("cpu", 42, 3).keep(x, 0.15)
        rows = slice(None) if device_rows is None else slice(device_rows[0], device_rows[1])
        for r in range(2):
            n = x.shape[dim] // 2
            part = x[rows].narrow(dim, r * n, n)
            got = DropoutRNG("cpu", 42, 3, device_rows).keep(part, 0.15, (dim, r, 2))
            assert torch.equal(got, whole[rows].narrow(dim, r * n, n)), (shape, r)


# ---------------------------------------------------------- the ranks
def test_cli_devices_2_mesh_model_2_on_the_cpu(cli_env, tmp_path):  # noqa: F811
    """``--devices 2 --mesh-model 2 --device cpu`` through the CLI with
    ``run.tp_min_dim`` 16: one epoch with validation, the challenge JSON,
    one checkpoint holding the whole state and one history line."""
    from transfusion_torch.runner.run_experiment import main

    config = os.path.join(os.path.dirname(cli_env["config"]), "run_tp.yml")
    with open(config, "w") as fp:
        fp.write(RUN_CFG.replace("\nrun:\n", "\nrun:\n  tp_min_dim: 16\n", 1))
    run_dir = str(tmp_path / "tp")
    main(["--config", config, "--device", "cpu", "--devices", "2", "--mesh-model", "2",
          "--run-dir", run_dir, "--epochs", "1"])
    history = [json.loads(line) for line in open(os.path.join(run_dir, "history.jsonl"))]
    assert len(history) == 1
    rec = history[0]
    assert rec["train_steps"] == 2 and rec["train_nonfinite_skipped"] == 0.0
    assert np.isfinite(rec["train_loss"]) and 0.0 <= rec["map_box_noun_verb_val"] <= 100.0
    assert len(json.load(open(os.path.join(run_dir, "results", "val_epoch0.json")))["results"]) == 4
    state = torch.load(os.path.join(run_dir, "checkpoints", "epoch_0000", "state.pt"),
                       weights_only=True)
    qkv = [k for k in state["model"] if k.endswith("self_attn.in_proj_weight")]
    assert qkv and all(state["model"][k].shape[0] == 3 * state["model"][k].shape[1] for k in qkv)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 2-rank and 4-rank groups, and meanwhile here the one-rank
    ``fit(1)`` in f32 and in f64 (1 thread, as a rank has)."""
    out = tmp_path_factory.mktemp("tp")
    model, _ = _tiny_model()
    batch, hw = _fixed_batch()
    init = jax.jit(lambda k, b: model.init({"params": k}, dict(b, image_hw=hw), False))
    golden_sd = state_dict_from_jax(jax.device_get(init(jax.random.key(1234), batch)))
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    tbatch["image_hw"] = hw
    # A one-rank checkpoint of the initial state for the ranks to resume.
    fresh = wk._tp_trainer(wk.tp_run_config(), str(out / "init"), device="cpu",
                           data=wk.tp_data())
    fresh.ensure_state()
    one_ckpt = fresh.ckpt.save(0, fresh.model, fresh.state)
    payload = {"golden_cfg": _port_cfg(), "golden_sd": golden_sd, "golden_batch": tbatch,
               "freqs": torch.from_numpy(FREQS), "one_ckpt": one_ckpt}

    def one_rank():
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            return (wk.tp_fit(wk.tp_run_config(), str(out / "one")),
                    wk.tp_fit(wk.tp_run_config(), str(out / "one_f64"), f64=True))
        finally:
            torch.set_num_threads(threads)

    one, one64 = wk.spawn_groups(wk.tp_rank, (2, 4), payload, str(out), meanwhile=one_rank)
    load = lambda w, r: torch.load(out / f"tp{w}_rank{r}.pt", weights_only=False)  # noqa: E731
    return {"one": one, "one64": one64, "two": [load(2, r) for r in range(2)],
            "four": [load(4, r) for r in range(4)], "out": out, "one_ckpt": one_ckpt}


def _rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def _same_draws_and_losses(got: dict, one: dict, what: str) -> None:
    """The same dropout draws (generator state, global shape, dtype: the
    same masks bit for bit) and every loss within 1e-5 relative."""
    assert len(one["draws"]) > 0 and got["draws"] == one["draws"], what
    for k, v in one["metrics"].items():
        if "loss" in k and not k.startswith("val_"):
            np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-5, atol=1e-7,
                                       err_msg=f"{what} {k}")
    assert got["metrics"]["train_nonfinite_skipped"] == 0.0


def _same_updates(got: dict, one: dict, what: str, tol: float) -> None:
    """Each parameter's update, running average and optimizer moment within
    ``tol`` relative L2 of the one-rank run's."""
    init = one["init"]
    for k, v in one["model"].items():
        if k in init:
            assert _rel(got["model"][k] - init[k], v - init[k]) <= tol, (what, k)
        elif k.endswith(("running_mean", "running_var")):
            assert _rel(got["model"][k], v) <= tol, (what, k)
    for m in ("mu", "nu"):
        for k, v in one["opt_state"][m].items():
            assert _rel(got["opt_state"][m][k], v) <= tol, (what, m, k)


def _same_evaluation(got: dict, one: dict, what: str) -> None:
    """Every image evaluated once: the one-rank run's result JSON keys, as
    many detections an image, and its mAP."""
    results, want = got["results"]["results"], one["results"]["results"]
    assert results.keys() == want.keys() and len(want) == wk.TP_VAL, what
    for uid, dets in want.items():
        assert len(results[uid]) == len(dets), (what, uid)
    for k, v in one["metrics"].items():
        if k.endswith("_val") and not k.startswith("val_"):
            np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-5, atol=1e-6,
                                       err_msg=f"{what} {k}")


def test_two_model_ranks_reproduce_the_golden_detections(runs):
    """The golden tiny model split over 2 model ranks: its eval forward and
    detections give tests/golden/tiny_detections.npz on both ranks, with
    one all-reduce a Megatron pair (2 levels x 2, 2 back-projections,
    MiniLM's 1 layer x 2, fc7)."""
    want = np.load(GOLDEN)
    for rank in runs["two"]:
        got = rank["golden"]
        assert got["all_reduce"] == 2 * 2 + 2 + 2 + 1 and got["split"] == 27
        assert set(want.files) == set(got["dets"])
        for key in want.files:
            g = got["dets"][key].numpy()
            if want[key].dtype.kind in "fc":
                np.testing.assert_allclose(g, want[key], rtol=1e-4, atol=1e-3, err_msg=key)
            else:
                np.testing.assert_array_equal(g, want[key], err_msg=key)


def test_two_model_ranks_train_as_one_rank_in_f32(runs):
    """fit(1) at model 2 in f32 (one step of the tiny trainable-BN config,
    dropout 0.15 at every site, clipping at 4, then an evaluation): the
    same dropout masks and losses as one rank, the same evaluation; both
    ranks hold the same whole state and half of each split parameter. In
    f32 this tiny random-weight model turns rounding into update gaps
    (the updates are held in f64 below)."""
    one = runs["one"]
    for rank in runs["two"]:
        _same_draws_and_losses(rank["fit"], one, "model 2")
        _same_evaluation(rank["fit"], one, "model 2")
    r0, r1 = (r["fit"] for r in runs["two"])
    for k, v in r0["model"].items():
        assert torch.equal(v, r1["model"][k]), k
    assert r0["local_numel"] < sum(v.numel() for k, v in one["model"].items() if k in one["init"])
    c = r0["collectives"]
    # The step's own: the guard's verdict, clipping's norm, one bucket of
    # model rank 0's gradients of the whole tensors.
    assert c["all_reduce"] > 0 and c["all_gather"] > 0 and c["step"] == 3


def test_two_model_ranks_train_as_one_rank_in_f64(runs):
    """The same fit(1) with the model in float64: masks bit for bit, losses
    within 1e-5 and every update, running average and moment within 1e-4
    relative L2 of one rank's."""
    r0, r1 = (r["fit64"] for r in runs["two"])
    for rank in (r0, r1):
        _same_draws_and_losses(rank, runs["one64"], "model 2 f64")
    for k, v in r0["model"].items():
        assert torch.equal(v, r1["model"][k]), k
    _same_updates(r0, runs["one64"], "model 2 f64", 1e-4)
    _same_evaluation(r0, runs["one64"], "model 2 f64")


def test_checkpoints_cross_between_model_2_and_model_1(runs):
    """A model-2 checkpoint resumes at one rank with the ranks' whole state
    bit for bit; a one-rank checkpoint resumes at model 2 and gathers to it
    bit for bit."""
    path = runs["out"] / "tp2" / "checkpoints" / "epoch_0000"
    saved = torch.load(path / "state.pt", weights_only=True)
    back = wk._tp_trainer(wk.tp_run_config(), str(runs["out"] / "back"), device="cpu",
                          data=wk.tp_data())
    back.ensure_state(resume_from=str(path))
    ranks = runs["two"][0]["fit"]
    for k, v in back.model.state_dict().items():
        assert torch.equal(v, saved["model"][k]) and torch.equal(v, ranks["model"][k]), k
    for m in ("mu", "nu"):
        for k, v in back.state.opt_state[m].items():
            assert torch.equal(v, ranks["opt_state"][m][k]), (m, k)
    one_saved = torch.load(os.path.join(runs["one_ckpt"], "state.pt"), weights_only=True)
    for rank in runs["two"]:
        for k, v in one_saved["model"].items():
            assert torch.equal(rank["resume"]["model"][k], v), k


def test_data_2_by_model_2_with_fsdp_trains_as_one_rank(runs):
    """fit(1) in f64 on a (2, 2) mesh with FSDP over the data axis: the same
    draws, losses, updates, running averages and moments as one rank;
    every rank the same whole state and fewer moments than at model 2
    alone; the gathered evaluation counts each image once."""
    one = runs["one64"]
    r0 = runs["four"][0]["fit64"]
    for rank in runs["four"]:
        _same_draws_and_losses(rank["fit64"], one, "2 x 2")
        for k, v in rank["fit64"]["model"].items():
            assert torch.equal(v, r0["model"][k]), k
    _same_updates(r0, one, "2 x 2", 1e-4)
    _same_evaluation(r0, one, "2 x 2")
    assert r0["local_opt_numel"] < runs["two"][0]["fit64"]["local_opt_numel"]
