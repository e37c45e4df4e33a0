"""MobileNetV3-Large's blocks, trunk and freeze rules in the port against
the JAX package's, on the CPU (helpers, inputs and tolerances as
tests/test_torch_backbones.py)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_backbones import HW, _body_state, _close_maps, _filled, _image, _jax_apply, _nchw
from tests.torch_threads import cap_torch_threads  # noqa: F401
from transfusion_torch import weights as W


# ------------------------------------------------------------- MobileNet
INVERTED = {
    "no_expand_residual": (16, (3, 16, 16, False, "relu", 1)),
    "se_stride2": (24, (5, 72, 40, True, "relu", 2)),
    "hardswish_residual": (80, (3, 184, 80, False, "hardswish", 1)),
    "se_hardswish_residual": (112, (3, 672, 112, True, "hardswish", 1)),
}


@pytest.mark.parametrize("case", list(INVERTED))
def test_inverted_residual_matches_jax(case):
    """One block with and without squeeze-excite, expansion and residual."""
    from transfusion_torch.models.mobilenet import InvertedResidual
    from transfusion_tpu.models.mobilenet import InvertedResidual as JBlock

    cin, setting = INVERTED[case]
    x = _image(6, c=cin, hw=(16, 24))
    jm = JBlock(*setting)
    variables = _filled(jm, jnp.asarray(x))
    want = _jax_apply(jm, variables, jnp.asarray(x))
    state = W.resnet_state_dict_from_jax({"block_0": variables["params"]})
    port = InvertedResidual(cin, *setting)
    port.load_state_dict({k.removeprefix("1."): v for k, v in state.items()}, strict=True)
    with torch.no_grad():
        _close_maps(port(_nchw(x)), want, 2e-5)


def test_mobilenet_features_match_jax():
    """The trunk's four returned levels; JAX's dead blocks 13 and 14 are
    skipped by the weights and not built by the port."""
    from transfusion_torch.models.mobilenet import MOBILENET_CHANNELS, MobileNetV3Features
    from transfusion_tpu.models.mobilenet import MobileNetV3Features as JTrunk

    x = _image(7)
    jm = JTrunk()
    variables = _filled(jm, jnp.asarray(x))
    assert {"block_13", "block_14"} <= set(variables["params"])
    want = _jax_apply(jm, variables, jnp.asarray(x))
    port = MobileNetV3Features()
    port.load_state_dict(_body_state(variables), strict=True)
    with torch.no_grad():
        got = port(_nchw(x))
    assert sorted(got) == sorted(want) == ["0", "1", "2", "3"]
    for k in want:
        assert got[k].shape[1] == MOBILENET_CHANNELS[k]
        _close_maps(got[k], want[k], 2e-5, k)


# --------------------------------------------------------- freeze rules
@functools.lru_cache(maxsize=1)
def _mobilenet_trunk_shapes():
    from transfusion_tpu.models.mobilenet import MobileNetV3Features as JTrunk

    return jax.eval_shape(lambda k: JTrunk().init(k, jnp.zeros((1, *HW, 3))),
                          jax.random.key(0))["params"]


@pytest.mark.parametrize("trainable_layers", range(7))
def test_mobilenet_freeze_rules_match_jax(trainable_layers):
    """backbone_stop_grad_stages (0: no tape cut) and unfreeze_multipliers
    on every parameter of a MobileNet body (under JAX's ``backbone`` path
    and the port's ``backbone.body.``), before and after the backbone's
    train_ep; a parameter outside the body trains in both."""
    from transfusion_torch.models.mobilenet import MobileNetV3Features
    from transfusion_torch.runner.trainer import backbone_stop_grad_stages as t_stop
    from transfusion_torch.runner.trainer import unfreeze_multipliers as t_mult
    from transfusion_tpu.runner.trainer import backbone_stop_grad_stages as j_stop
    from transfusion_tpu.runner.trainer import unfreeze_multipliers as j_mult

    shapes = {"backbone": _mobilenet_trunk_shapes(), "fpn": {"kernel": jnp.zeros((1, 1))}}
    names = [f"backbone.body.{n}" for n, _ in MobileNetV3Features().named_parameters()]
    mcfg = {"type": "mobilenet", "train_ep": 1, "trainable_layers": trainable_layers}
    trained = set()
    for epoch in (0, 1):
        assert t_stop(epoch, mcfg) == j_stop(epoch, mcfg) == 0
        tree = j_mult(shapes, epoch, mcfg, -1, 1, 1)
        assert float(tree["fpn"]["kernel"]) == 1.0
        want = W.resnet_state_dict_from_jax(jax.tree.map(
            lambda m, x: np.full(x.shape, m, np.float32), tree["backbone"], shapes["backbone"]))
        got = t_mult([(n, None) for n in names + ["backbone.fpn.inner_blocks.0.weight"]], epoch,
                     mcfg, -1, 1, 1)
        assert got["backbone.fpn.inner_blocks.0.weight"] == 1.0
        for n in names:
            assert np.unique(want[n.removeprefix("backbone.body.")].numpy()).tolist() == [got[n]], \
                (epoch, n)
        trained |= {n for n in names if got[n]}
    first = {0: None, 1: None, 2: 13, 3: 7, 4: 4, 5: 2, 6: 0}[trainable_layers]
    units = {int(n.split(".")[2]) for n in trained}
    assert units == (set() if first is None else set(range(first, 14)))
