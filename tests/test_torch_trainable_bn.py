"""Trainable BatchNorm in the port (``model.batch_norm.use``) against the
JAX package on the CPU:
  * one BatchNorm against flax's ``nn.BatchNorm`` as JAX's ``ConvNorm``
    builds it (training output, new running averages, the VJP for the
    input, scale and bias; eval output), at momentum 0.1 and 0.3, in f32
    and in bf16 compute;
  * the ResNet body against JAX's ``ResNet(stage_sizes=(1, 1, 1, 1),
    trainable_bn=True)`` (4 images at 64x64, every norm's scale, bias and
    running averages from a seed): training outputs, new ``batch_stats``
    and eval outputs at both momenta and dtypes, and the VJP for the input
    and every scale and bias in float64 (JAX under ``enable_x64``);
then the port's train step with the trainable trunk: a non-finite step
keeps the running averages, and stages behind the freeze schedule's tape
cut still update them.

Tolerances, relative to the reference's largest magnitude. One BatchNorm
(per-channel means within about one spread of 0, as after a conv): f32
1e-5 for everything; bf16 outputs 1e-2 (one bf16 ulp of the output),
running averages 1e-5 (f32 statistics of the same bf16 input), gradients
1e-2 (each of the two gradient terms is rounded to bf16). The body: f32
outputs 1e-4 and running averages 1e-5 (flax's fast variance E[x^2] -
E[x]^2 in f32, summed in another order, feeds 17 normalisations; eval,
which has none of it, agrees to 1e-6 and is held at 1e-5); bf16 training
outputs 5e-2 and eval outputs 3e-2 (17 layers of bf16 roundings, some of
which XLA's fusion keeps in f32), running averages 1e-2; the float64
VJP 1e-9 (an f32 parameter's gradient is rounded to f32 on both sides:
2e-7). Gradients are compared in float64 because in f32 a ReLU whose input
lies within rounding of 0 flips between the two and moves a scale's
gradient by a whole cotangent entry. Where a channel's mean is ten
spreads from 0, flax's f32 fast variance cancels and JAX's own output is
1.6e-4 off its float64 value: there the port is held to float64 instead.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_threads import cap_torch_threads  # noqa: F401
from transfusion_torch.weights import resnet_state_dict_from_jax

N, S = 4, 64
BN_TOL = {"float32": (1e-5, 1e-5, 1e-5), "bfloat16": (1e-2, 1e-5, 1e-2)}  # out, stats, grads
BODY_TOL = {"float32": (1e-4, 1e-5, 1e-5), "bfloat16": (5e-2, 1e-2, 3e-2)}  # train, stats, eval


def _fill(shapes, seed: int):
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "kernel":
            v = rng.normal(0, 1, s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        elif name == "var":
            v = rng.uniform(0.5, 1.5, s.shape)
        elif name == "scale":
            v = 1 + rng.normal(0, 0.1, s.shape)
        else:
            v = rng.normal(0, 0.3, s.shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _close(got, want, tol, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("momentum", [0.1, 0.3])
def test_batch_norm_matches_flax(dtype, momentum):
    import flax.linen as fnn

    from transfusion_torch.ops.batch_norm import BatchNorm

    t_out, t_stats, t_grad = BN_TOL[dtype]
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    rng = np.random.default_rng(3)
    c = 24
    x = (rng.normal(0, 1, (4, 9, 7, c)) * rng.uniform(0.5, 2, c) + rng.normal(0, 0.5, c))
    x = np.array(jnp.asarray(x, jnp.float32).astype(jdt).astype(jnp.float32))  # dtype-exact
    scale, bias = 1 + rng.normal(0, 0.1, c), rng.normal(0, 0.3, c)
    mean, var = rng.normal(0, 0.5, c), rng.uniform(0.5, 1.5, c)
    params = {"scale": jnp.asarray(scale, jnp.float32), "bias": jnp.asarray(bias, jnp.float32)}
    stats = {"mean": jnp.asarray(mean, jnp.float32), "var": jnp.asarray(var, jnp.float32)}
    bn = fnn.BatchNorm(momentum=1.0 - momentum, epsilon=1e-5, dtype=jdt)

    def train(xx, p):
        y, new = bn.apply({"params": p, "batch_stats": stats}, xx, use_running_average=False,
                          mutable=["batch_stats"])
        return y, new["batch_stats"]

    xj = jnp.asarray(x).astype(jdt)
    (y, new), vjp = jax.vjp(train, xj, params)
    cot = rng.normal(0, 1, x.shape).astype(np.float32)
    gx, gp = vjp((jnp.asarray(cot).astype(y.dtype), jax.tree.map(jnp.zeros_like, new)))
    y_eval = bn.apply({"params": params, "batch_stats": stats}, xj, use_running_average=True)

    port = BatchNorm(c, momentum)
    with torch.no_grad():
        for t, v in ((port.weight, scale), (port.bias, bias), (port.running_mean, mean),
                     (port.running_var, var)):
            t.copy_(torch.tensor(v, dtype=torch.float32))
    xt = torch.from_numpy(x).to(tdt).permute(0, 3, 1, 2).detach().requires_grad_()
    yt = port(xt, train=True)
    yt.backward(torch.from_numpy(cot).to(tdt).permute(0, 3, 1, 2))
    _close(yt.detach().float().permute(0, 2, 3, 1), jnp.asarray(y, jnp.float32), t_out, "output")
    _close(port.running_mean, new["mean"], t_stats, "running mean")
    _close(port.running_var, new["var"], t_stats, "running variance")
    _close(xt.grad.float().permute(0, 2, 3, 1), jnp.asarray(gx, jnp.float32), t_grad, "dx")
    _close(port.weight.grad, gp["scale"], t_grad, "dscale")
    _close(port.bias.grad, gp["bias"], t_grad, "dbias")
    with torch.no_grad():
        port.running_mean.copy_(torch.tensor(mean))
        port.running_var.copy_(torch.tensor(var))
        ye = port(xt.detach(), train=False)
    _close(ye.float().permute(0, 2, 3, 1), jnp.asarray(y_eval, jnp.float32), t_out, "eval output")


def test_batch_norm_statistics_where_the_mean_dwarfs_the_spread():
    """Where mean^2 / var reaches about 130 the f32 fast variance E[x^2] -
    E[x]^2 cancels: the port's output stays within 1e-5 of the float64
    value of flax's formula, and at least as close to it as JAX's own f32
    run (which is about 1.6e-4 off here: XLA's f32 reduction)."""
    import flax.linen as fnn

    from transfusion_torch.ops.batch_norm import BatchNorm

    rng = np.random.default_rng(3)
    c = 24
    x = (rng.normal(0, 1, (4, 9, 7, c)) * rng.uniform(0.2, 3, c) + rng.normal(0, 2, c))
    x = x.astype(np.float32)
    scale, bias = (1 + rng.normal(0, 0.1, c)).astype(np.float32), rng.normal(0, 0.3, c).astype(np.float32)
    x64 = x.astype(np.float64)
    m = x64.mean((0, 1, 2))
    v = (x64 * x64).mean((0, 1, 2)) - m * m
    assert (m * m / v).max() > 100
    truth = (x64 - m) / np.sqrt(v + 1e-5) * scale + bias
    y, _ = fnn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=jnp.float32).apply(
        {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
         "batch_stats": {"mean": jnp.zeros(c), "var": jnp.ones(c)}},
        jnp.asarray(x), use_running_average=False, mutable=["batch_stats"])
    port = BatchNorm(c)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(scale))
        port.bias.copy_(torch.from_numpy(bias))
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2), train=True).permute(0, 2, 3, 1).numpy()
    _close(got, truth, 1e-5, "port against float64")
    assert np.abs(got - truth).max() <= np.abs(np.asarray(y) - truth).max()


def _body(dtype, momentum):
    from transfusion_tpu.models.resnet import ResNet as JResNet

    jmodel = JResNet(stage_sizes=(1, 1, 1, 1), dtype=dtype, trainable_bn=True, bn_momentum=momentum)
    x = np.random.default_rng(1).normal(0.2, 1.0, (N, S, S, 3)).astype(np.float32)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.key(0), jnp.asarray(x)))
    tree = _fill(shapes, 2)
    return jmodel, x, tree["params"], tree["batch_stats"]


def _port_body(tdt, momentum, params, stats):
    from transfusion_torch.models.resnet import ResNet as TResNet

    port = TResNet((1, 1, 1, 1), dtype=tdt, trainable_bn=True, bn_momentum=momentum)
    port.load_state_dict(resnet_state_dict_from_jax(params, stats), strict=True)
    return port


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("momentum", [0.1, 0.3])
def test_resnet_trainable_bn_matches_jax(dtype, momentum):
    t_train, t_stats, t_eval = BODY_TOL[dtype]
    jmodel, x, params, stats = _body(getattr(jnp, dtype), momentum)
    run = jax.jit(lambda xx, train: jmodel.apply({"params": params, "batch_stats": stats}, xx, train,
                                                 mutable=["batch_stats"]), static_argnums=1)
    feats, new = run(jnp.asarray(x), True)
    evaled, _ = run(jnp.asarray(x), False)
    port = _port_body(getattr(torch, dtype), momentum, params, stats)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = port(xt, train=True)
        sd = {k: v.clone() for k, v in port.state_dict().items()}
        port.load_state_dict(resnet_state_dict_from_jax(params, stats))
        ev = port(xt, train=False)
    for k in feats:
        _close(got[k].float().permute(0, 2, 3, 1), jnp.asarray(feats[k], jnp.float32), t_train,
               f"train output {k}")
        _close(ev[k].float().permute(0, 2, 3, 1), jnp.asarray(evaled[k], jnp.float32), t_eval,
               f"eval output {k}")
    want = resnet_state_dict_from_jax(params, new["batch_stats"])
    names = [n for n in sd if n.endswith(("running_mean", "running_var"))]
    assert len(names) == 2 * 17
    for n in names:
        _close(sd[n], want[n], t_stats, n)


def test_resnet_trainable_bn_vjp_matches_jax_in_float64():
    with jax.enable_x64(True):
        jmodel, x, params, stats = _body(jnp.float64, 0.1)

        def train(xx, p):
            return jmodel.apply({"params": p, "batch_stats": stats}, xx, True,
                                mutable=["batch_stats"])[0]

        feats, vjp = jax.vjp(train, jnp.asarray(x, jnp.float64), params)
        rng = np.random.default_rng(6)
        cots = {k: rng.normal(0, 1, v.shape) for k, v in feats.items()}
        gx, gp = vjp({k: jnp.asarray(v) for k, v in cots.items()})
        gx, gp = np.asarray(gx), jax.tree.map(np.asarray, gp)
    port = _port_body(torch.float64, 0.1, params, stats)
    xt = torch.from_numpy(x.astype(np.float64)).requires_grad_()
    got = port(xt.permute(0, 3, 1, 2), train=True)
    torch.autograd.backward([got[k] for k in sorted(got)],
                            [torch.from_numpy(cots[k]).permute(0, 3, 1, 2) for k in sorted(got)])
    _close(xt.grad, gx, 1e-9, "input gradient")
    want = resnet_state_dict_from_jax(gp)
    norms = 0
    for n, p in port.named_parameters():
        tol = 2e-7 if p.dtype == torch.float32 else 1e-9
        _close(p.grad, want[n], tol, f"gradient {n}")
        norms += n.endswith(("bn1.weight", "bn2.bias", "downsample.1.weight"))
    assert norms == 1 + 4 + 4 + 4


def _tiny_bn_model(stop_grad: int):
    from transfusion_torch.models.detector import DetectorConfig
    from transfusion_torch.models.roi_heads import RoIConfig
    from transfusion_torch.models.text_encoder import BertConfig
    from transfusion_torch.models.transfusion import FusionConfig, TransFusion, TransFusionConfig
    from transfusion_torch.weights import init_random_

    cfg = TransFusionConfig(
        detector=DetectorConfig(roi=RoIConfig(num_nouns=7, num_verbs=5, representation_size=32,
                                              batch_size_per_image=16),
                                stage_sizes=(1, 1, 1, 1), trainable_bn=True, bn_momentum=0.3,
                                stop_grad_stages=stop_grad),
        fusion=FusionConfig(fpn_features=(3,), patch_h=(1,), patch_w=(1,), num_layers=(1,),
                            token_dim=32, num_heads=2),
        bert=BertConfig(vocab_size=64, hidden_size=16, num_layers=1, num_heads=2,
                        intermediate_size=32, max_position_embeddings=16),
        out_mlp=32)
    return init_random_(TransFusion(cfg, device="cpu"), seed=3)


def _step(model, stop_grad: int):
    from transfusion_torch.runner.trainer import unfreeze_multipliers
    from transfusion_torch.train.optim import make_optimizer
    from transfusion_torch.train.step import LossConfig, TrainState, make_train_step

    tx, _ = make_optimizer({"name": "radam", "lr": 1e-3}, None, 1)
    state = TrainState(step=0, opt_state=tx.init(dict(model.named_parameters())))
    step = make_train_step(model, tx, LossConfig(rpn_batch_size_per_image=32), torch.ones(7),
                           torch.ones(6))
    model_cfg = {"train_ep": 0 if stop_grad == 0 else -1, "trainable_layers": 5}
    mult = unfreeze_multipliers(model.named_parameters(), 0, model_cfg, -1, 1, 1)
    return step, state, mult


def _batch(nan: bool = False):
    rng = np.random.default_rng(5)
    image = rng.normal(0, 0.7, (2, 64, 96, 3)).astype(np.float32)
    if nan:
        image[0, 3, 4, 1] = np.nan
    return {"image": torch.from_numpy(image), "image_hw": (64, 96),
            "input_ids": torch.from_numpy(rng.integers(0, 64, (2, 8))),
            "attention_mask": torch.ones(2, 8, dtype=torch.int64),
            "targets": {"boxes": torch.tensor([[[4.0, 6, 40, 50]], [[10.0, 8, 60, 44]]]),
                        "nouns": torch.tensor([[2], [5]]), "verbs": torch.tensor([[1], [3]]),
                        "ttcs": torch.tensor([[0.5], [1.2]]),
                        "valid": torch.tensor([[True], [True]])}}


def test_non_finite_step_keeps_the_running_averages():
    """A step whose batch holds a NaN is skipped: parameters, optimizer
    state and the running averages keep their values; the next finite step
    moves all three and TrainState.batch_stats names the live buffers."""
    from transfusion_torch.models.resnet import batch_stats

    model = _tiny_bn_model(0)
    step, state, mult = _step(model, 0)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    m = step(state, _batch(nan=True), np.ones(6, np.float32), mult)
    assert m["nonfinite_skipped"] == 1.0 and state.step == 1
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert state.opt_state["count"] == 0
    m = step(state, _batch(), np.ones(6, np.float32), mult)
    assert m["nonfinite_skipped"] == 0.0 and np.isfinite(float(m["loss"]))
    live = batch_stats(model)
    assert state.batch_stats is not None and set(state.batch_stats) == set(live)
    assert all(state.batch_stats[k] is live[k] for k in live)
    for k in live:
        assert not torch.equal(live[k], before[k]), k
    assert not torch.equal(model.state_dict()["backbone.body.bn1.weight"],
                           before["backbone.body.bn1.weight"])


def test_frozen_stages_still_update_the_running_averages():
    """With the whole trunk behind the tape cut (the flagship's epoch 0) the
    BatchNorms get no gradient and their weights stay, but every running
    average moves, as flax's batch_stats do under stop_gradient; eval mode
    reads the running averages and leaves them alone."""
    model = _tiny_bn_model(5)
    step, state, mult = _step(model, 5)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    m = step(state, _batch(), np.ones(6, np.float32), mult)
    assert m["nonfinite_skipped"] == 0.0
    sd = model.state_dict()
    stats = [k for k in sd if k.startswith("backbone.body.") and k.endswith(("running_mean",
                                                                            "running_var"))]
    assert len(stats) == 2 * 17
    for k in stats:
        assert not torch.equal(sd[k], before[k]), k
    for n, p in model.named_parameters():
        if n.startswith("backbone.body."):
            assert torch.equal(p.detach(), before[n]), n
    model.eval()
    after = {k: sd[k].clone() for k in stats}
    with torch.no_grad():
        model(_batch())
    for k in stats:
        assert torch.equal(model.state_dict()[k], after[k]), k


def test_build_transfusion_config_maps_batch_norm():
    """model.batch_norm.use / .momentum reach the detector config and build
    a trunk of trainable BatchNorms (JAX transfusion.py:533-534)."""
    from transfusion_torch.models.detector import DetectorConfig
    from transfusion_torch.models.transfusion import build_transfusion_config
    from transfusion_torch.ops.batch_norm import BatchNorm
    from transfusion_tpu.models.transfusion import build_transfusion_config as j_build
    from tests import torch_parallel_workers as wk

    cfg = wk.tiny_run_config()
    cfg["model"]["batch_norm"]["momentum"] = 0.3
    t = build_transfusion_config(cfg, 88, 75).detector
    j = j_build(cfg, 88, 75).detector
    assert (t.trainable_bn, t.bn_momentum) == (j.trainable_bn, j.bn_momentum) == (True, 0.3)
    model = _tiny_bn_model(0)
    assert sum(isinstance(m, BatchNorm) for m in model.modules()) == 17
    assert dataclasses.replace(DetectorConfig(), trainable_bn=True).bn_momentum == 0.1
