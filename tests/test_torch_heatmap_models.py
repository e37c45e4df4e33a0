"""The legacy heatmap family's models in the port against the JAX package's,
on the CPU: every ``misc_layers`` upsampler (bicubic and nearest at an odd
scale, bicubic also shrinking) and both heatmap conditions, ``ResnetNao``
in its heatmap + classify, kl_div and multivar modes, ``ScnnNao``, and
``HeatmapCrossFusion`` (asymmetric / embedding / regroup_gated,
cross_transformer / token_embeddings / regroup, the token back-projection,
and regroup without ``extra``), each with its JAX params carried by the new
``weights.py`` functions. One JAX model a configuration (each test builds
its own), its params from ``eval_shape`` filled by a seed (no JAX init
compile), applied once without ``jit``. Tiny configs: stage sizes (1, 1, 1, 1), Fast-SCNN's
widths divided by 4, token dim 32, 64x96 images.

Tolerance: f32 on both sides, outputs within 1e-5 relative and 1e-5 of
the largest magnitude (at least 1): the two frameworks sum the convs and
products in another order. Training mode is the port's alone (JAX's
dropout draws other bits): the dropout statistics are checked there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_language_paths import fill
from tests.torch_threads import cap_torch_threads  # noqa: F401
from transfusion_torch import weights as W

TOL = 1e-5
IMG = (64, 96)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, msg=""):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape, (got.shape, want.shape, msg)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * max(float(np.abs(want).max()), 1.0),
                               err_msg=msg)


def _close_out(got: dict, want: dict):
    for k, w in want.items():
        if w is None:
            assert got[k] is None, k
        elif isinstance(w, dict):
            for kk in w:
                _close(got[k][kk], w[kk], f"{k}.{kk}")
        else:
            _close(got[k], w, k)


def _filled(module, *args, seed=5):
    shapes = jax.eval_shape(lambda k: module.init(k, *args), jax.random.key(0))
    return fill(dict(shapes), seed)


def _nchw(x):
    return _t(x).permute(0, 3, 1, 2)


def _rand(seed, shape, loc=0.0, scale=1.0):
    return np.random.default_rng(seed).normal(loc, scale, shape).astype(np.float32)


# ------------------------------------------------------------ misc_layers
@pytest.mark.parametrize("kind", ["bilinear", "bicubic", "nn2d"])
def test_upsampler_matches_jax(kind):
    """Each upsampler at an odd scale (5x7 -> 13x18); bicubic also shrinks
    (13x18 -> 5x7, the antialiased kernel) and changes one axis only
    (5x7 -> 5x18); nn2d's nearest resize is held index for index."""
    from transfusion_torch.models import misc_layers as tm
    from transfusion_tpu.models import misc_layers as jm

    x = _rand(1, (2, 5, 7, 3))
    cases = [(x, (13, 18))]
    if kind == "bicubic":
        cases += [(_rand(2, (2, 13, 18, 3)), (5, 7)), (x, (5, 18))]
    for inp, size in cases:
        if kind == "nn2d":
            jmod = jm.NNConvUpsample2D(3)
            variables = _filled(jmod, jnp.asarray(inp), size)
            want = jmod.apply(variables, jnp.asarray(inp), size)
            port = tm.NNConvUpsample2D(3)
            p = variables["params"]
            port.load_state_dict({f"{c}.{k}": _t(W._conv(p[c]["kernel"]) if k == "weight" else p[c]["bias"])
                                  for c in ("conv1", "conv2") for k in ("weight", "bias")})
            np.testing.assert_array_equal(
                tm.nearest_resize(_nchw(inp), size).permute(0, 2, 3, 1).numpy(),
                np.asarray(jm._resize(jnp.asarray(inp), size, "nearest")))
        else:
            want = jm.get_upsample_l(kind)(3).apply({}, jnp.asarray(inp), size)
            port = tm.get_upsample_l(kind)(3)
        got = port(_nchw(inp), size).permute(0, 2, 3, 1)
        _close(got, want, f"{kind} {inp.shape} -> {size}")


def test_heatmap_conditions_match_jax():
    """Conv2dHeatmapCondition with and without the residual, and
    SqueezeHeatmapCondition (its SE block at r 1), through
    get_heatmap_cond_module."""
    from transfusion_torch.models import misc_layers as tm
    from transfusion_tpu.models import misc_layers as jm

    feat, hm = _rand(3, (2, 6, 8, 8)), _rand(4, (2, 6, 8, 1))
    for kind in ("1x1", "se_block"):
        jmod = jm.get_heatmap_cond_module({"type": kind}, 8)
        variables = _filled(jmod, jnp.asarray(feat), jnp.asarray(hm))
        p = variables["params"]
        port = tm.get_heatmap_cond_module({"type": kind}, 8)
        conv = p["conv2d"] if kind == "1x1" else p["conv2d"]["conv2d"]
        state = {"conv2d.weight": W._conv(conv["kernel"]), "conv2d.bias": np.asarray(conv["bias"])}
        if kind == "se_block":
            state = {f"conv2d.{k}": v for k, v in state.items()}
            state |= {f"se_block.{fc}.weight": W._lin(p["se_block"][fc]["kernel"]) for fc in ("fc1", "fc2")}
        port.load_state_dict({k: _t(v) for k, v in state.items()})
        args = (jnp.asarray(feat), jnp.asarray(hm))
        _close(port(_nchw(feat), _nchw(hm)).permute(0, 2, 3, 1), jmod.apply(variables, *args), kind)
        if kind == "1x1":
            _close(port(_nchw(feat), _nchw(hm), with_res=False).permute(0, 2, 3, 1),
                   jmod.apply(variables, *args, with_res=False), "1x1 without the residual")


# ------------------------------------------------------- ResnetNao, ScnnNao
RESNET_CASES = {
    "heatmap_classify": dict(heatmap_blocks=3, noun_classes=5, verb_classes=4, ttc_pred=True,
                             hmap_head_upscale=0.7),
    "kl_div": dict(heatmap_blocks=2, kl_div=True, w_sigmoid=True, upsample_kind="bicubic"),
    "multivar": dict(heatmap_blocks=3, multivar_n=True, noun_classes=5, resize_spec=IMG),
}


@pytest.fixture(scope="module")
def images():
    return _rand(7, (2, *IMG, 3), 0.2, 0.7)


@pytest.mark.parametrize("case", list(RESNET_CASES))
def test_resnet_nao_matches_jax(case, images):
    """The torchvision-stride trunk (heatmap-only builds no tail: kl_div
    stops at layer2), the head's round() width, the multivar split, the
    upsampling (bilinear, bicubic) and kl_div's log-softmax."""
    from transfusion_torch.models.resnet_nao import ResnetNao, ResnetNaoConfig
    from transfusion_tpu.models.resnet_nao import ResnetNao as JResnetNao
    from transfusion_tpu.models.resnet_nao import ResnetNaoConfig as JConfig

    kw = dict(stage_sizes=(1, 1, 1, 1), **RESNET_CASES[case])
    jmod = JResnetNao(JConfig(**kw))
    variables = _filled(jmod, jnp.asarray(images))
    want = jmod.apply(variables, jnp.asarray(images))
    port = ResnetNao(ResnetNaoConfig(**kw)).eval()
    port.load_state_dict(W.resnet_nao_state_dict_from_jax(variables["params"]), strict=True)
    if case == "kl_div":
        assert not hasattr(port, "layer3") and "layer3_0" not in variables["params"]
    with torch.no_grad():
        _close_out(port(_t(images)), want)


def test_scnn_nao_matches_jax(images):
    """Fast-SCNN at a quarter of the factory widths with heatmap,
    classification and TTC heads: learning to downsample, the bottleneck
    stacks, pyramid pooling (floor-mode windows on a 2x3 map), the fusion,
    the classification branch."""
    from transfusion_torch.models.scnn import ScnnNao, ScnnNaoConfig
    from transfusion_tpu.models.scnn import ScnnNao as JScnnNao
    from transfusion_tpu.models.scnn import ScnnNaoConfig as JConfig

    kw = dict(downsample_c=(8, 8, 12), feature_extractor_c=(12, 16, 24), num_blocks=(1, 1, 1),
              feature_fusion_c=(12, 24, 24), out_class_channels=32, noun_classes=5, verb_classes=4,
              ttc_pred=True)
    jmod = JScnnNao(JConfig(**kw))
    variables = _filled(jmod, jnp.asarray(images))
    want = jmod.apply(variables, jnp.asarray(images))
    port = ScnnNao(ScnnNaoConfig(**kw)).eval()
    port.load_state_dict(W.scnn_state_dict_from_jax(variables["params"]), strict=True)
    with torch.no_grad():
        _close_out(port(_t(images)), want)


# ------------------------------------------------------- HeatmapCrossFusion
FEAT = (2, 8, 12, 16)  # [B, h, w, C]: 4 x 6 patches of 2 x 2
FUSION_CASES = {
    "asymmetric_embedding_gated": dict(lang_len=1),
    "cross_tokens_regroup": dict(fusion_type="cross_transformer", narr_out_mode="token_embeddings",
                                 back_to_img_fn="regroup", elu_last=True, lang_len=5),
    "token_backproj": dict(narr_out_mode="token_embeddings", back_to_img_fn="token", lang_to_hmap=True,
                           kl_div=True, w_sigmoid=True, pos_embedding="sin1d", class_upscale=1.5,
                           lang_len=5),
    "regroup_no_extra": dict(fusion_type="cross_transformer", back_to_img_fn="regroup", extra=False,
                             activation="relu", lang_len=1),
}


@pytest.mark.parametrize("case", list(FUSION_CASES))
def test_heatmap_fusion_matches_jax(case):
    """Each fusion family, narration mode and back-projection, with noun,
    verb and TTC heads; 5 language tokens with three of one image's padded
    where the mode takes tokens; upsampled to 32 x 48."""
    from transfusion_torch.models.heatmap_fusion import HeatmapCrossFusion, HeatmapFusionConfig
    from transfusion_tpu.models.heatmap_fusion import HeatmapCrossFusion as JFusion
    from transfusion_tpu.models.heatmap_fusion import HeatmapFusionConfig as JConfig

    kw = dict(FUSION_CASES[case])
    t = kw.pop("lang_len")
    kw |= dict(token_dim=32, vis_layers=2, lang_layers=1, noun_classes=5, verb_classes=4, ttc_pred=True)
    feat = _rand(11, FEAT, 0.0, 1.0)
    lang = _rand(12, (FEAT[0], t, 32))
    mask = np.ones((FEAT[0], t), np.int32)
    mask[1, 2:] = 0
    args = (jnp.asarray(feat), jnp.asarray(lang), jnp.asarray(mask))
    jmod = JFusion(JConfig(**kw))
    variables = _filled(jmod, *args)
    want = jmod.apply(variables, *args, im_size=(32, 48))
    port = HeatmapCrossFusion(HeatmapFusionConfig(**kw, feature_channels=FEAT[3], feature_hw=FEAT[1:3])).eval()
    port.load_state_dict(W.heatmap_fusion_state_dict_from_jax(variables["params"]), strict=True)
    with torch.no_grad():
        _close_out(port(_t(feat), _t(lang), _t(mask), im_size=(32, 48)), want)


# ------------------------------------------------------------ training mode
def test_training_mode_dropout_statistics(monkeypatch):
    """In training mode every dropout site draws from the step's
    DropoutRNG: without one the forward raises; at rate 0.5 each site
    zeroes about half of its entries (within 5 standard deviations) and
    scales the rest by 2; the same (seed, step) gives the same output bits
    and another step other bits; at rate 0 training equals eval."""
    import transfusion_torch.models.heatmap_fusion as hf
    import transfusion_torch.models.resnet_nao as rn
    from transfusion_torch.models.text_encoder import DropoutRNG

    cfg = hf.HeatmapFusionConfig(token_dim=32, vis_layers=2, lang_layers=1, noun_classes=5, verb_classes=4,
                                 ttc_pred=True, feature_channels=FEAT[3], feature_hw=FEAT[1:3],
                                 patch_dropout=0.5, vis_dropout=0.5, lang_dropout=0.5, backproj_dropout=0.5,
                                 class_dropout=0.5, ttc_dropout=0.5)
    torch.manual_seed(0)
    model = hf.HeatmapCrossFusion(cfg).train()
    feat, lang = _t(_rand(11, FEAT)), _t(_rand(12, (FEAT[0], 1, 32)))
    with pytest.raises(ValueError, match="DropoutRNG"):
        model(feat, lang)
    seen = []
    real = hf.dropout

    def watch(x, rate, training, rng, shard=None):
        y = real(x, rate, training, rng, shard)
        if training and rate > 0:
            seen.append((x.detach(), y.detach(), rate))
        return y

    monkeypatch.setattr(hf, "dropout", watch)
    monkeypatch.setattr(rn, "dropout", watch)  # the class heads'
    a = model(feat, lang, rng=DropoutRNG("cpu", 3, 7))
    assert len(seen) == 5  # patch tokens, back-projection, noun, verb, TTC
    for x, y, rate in seen:
        live = x != 0
        zero = (y == 0) & live
        n = int(live.sum())
        share = float(zero.sum()) / n
        assert abs(share - rate) <= 5 * (rate * (1 - rate) / n) ** 0.5, share
        torch.testing.assert_close(y[live & ~zero], (x / (1 - rate))[live & ~zero])
    monkeypatch.undo()
    b = model(feat, lang, rng=DropoutRNG("cpu", 3, 7))
    c = model(feat, lang, rng=DropoutRNG("cpu", 3, 8))
    assert torch.equal(a["heatmap"], b["heatmap"]) and torch.equal(a["noun_logits"], b["noun_logits"])
    assert not torch.equal(a["heatmap"], c["heatmap"])
    zero_rates = {f: 0.0 for f in ("patch_dropout", "vis_dropout", "lang_dropout", "backproj_dropout",
                                   "class_dropout", "ttc_dropout")}
    still = hf.HeatmapCrossFusion(hf.HeatmapFusionConfig(**{**cfg.__dict__, **zero_rates}))
    still.load_state_dict(model.state_dict())
    with torch.no_grad():
        got = still.train()(feat, lang)
        want = still.eval()(feat, lang)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
