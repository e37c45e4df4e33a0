"""The fusion options and the LM head of the port against the JAX package,
on the CPU in f32: every positional kind, the cross-transformer level with
ReLU, no final norm, a shared stack and clip features, the asymmetric QKV
level, the three space-time modules, the clip-feature fusion, the
narration encoder's embedding mode, the LM head (PoolPredictor) and
``lm_loss`` (value and gradient against ``jax.grad``), then two whole tiny
models (the JAX CLI's LM config, and a shared stack with summed language,
per-level heads, learned positions, clip features and embedding mode), each
from one jitted JAX init and apply. JAX parameters reach the port through
``weights.state_dict_from_jax`` (or its per-module helpers), so the
mapping is checked with the arithmetic; for each of the five families
``state_dict_from_jax`` must fill every port parameter.

Tolerances: module and model outputs at rtol 1e-4 / atol 1e-4 (f32 stacks
in another order agree to about 1e-5 relative); detections at rtol 1e-4 /
atol 1e-3 with integers exact, as tests/test_torch_slice.py holds them.
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_threads import cap_torch_threads  # noqa: F401
from transfusion_torch import weights as W

D, HEADS = 32, 2


def _close(got, want, rtol=1e-4, atol=1e-4, msg=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=rtol, atol=atol, err_msg=msg)


def _t(x):
    return torch.from_numpy(np.array(x))


def _load(module, sd: dict):
    module.load_state_dict({k: _t(np.asarray(v, np.float32)) for k, v in sd.items()}, strict=True)
    return module.eval()


def _nchw(x):
    return _t(x).permute(0, 3, 1, 2).contiguous()


def _inputs(seed=0, b=2, h=8, w=12, c=8, n_lang=5):
    rng = np.random.default_rng(seed)
    feat = rng.normal(0, 1, (b, h, w, c)).astype(np.float32)
    lang = rng.normal(0, 1, (b, n_lang, D)).astype(np.float32)
    mask = np.ones((b, n_lang), np.int32)
    mask[1, -2:] = 0
    return feat, lang, mask


# ------------------------------------------------------------- the modules
@pytest.mark.parametrize("kind", ["sin1d", "sin2d", "learned", "zero"])
def test_positional_embedding_matches_jax(kind):
    """x + table[:n] for every kind (sin2d over a 3 x 4 grid); sin2d
    without a grid raises in both packages."""
    from transfusion_torch.models.fusion import PositionalEmbedding as TPos
    from transfusion_tpu.models.fusion import PositionalEmbedding as JPos

    x = np.random.default_rng(1).normal(0, 1, (2, 12, D)).astype(np.float32)
    jm = JPos(kind, 64, D)
    variables = jm.init(jax.random.key(0), jnp.asarray(x), grid_hw=(3, 4))
    ref = jm.apply(variables, jnp.asarray(x), grid_hw=(3, 4))
    tm = TPos(D, 64, kind)
    if kind in ("learned", "zero"):
        _load(tm, {"pos_embedding": variables["params"]["pos_embedding"]})
    _close(tm(_t(x), grid_hw=(3, 4)), ref, rtol=1e-6, atol=1e-6)
    if kind == "sin2d":
        with pytest.raises(ValueError, match="grid_hw"):
            jm.apply(variables, jnp.asarray(x))
        with pytest.raises(ValueError, match="grid_hw"):
            tm(_t(x))


class _JLevelHost(fnn.Module):
    """A flax parent that owns a shared stack and a clip-feature fusion and
    hands them to one CrossFusionLevel, as JAX's TransFusion.setup does."""

    cfg: object
    out_channels: int
    shared: int = 0
    vis: bool = False

    def setup(self):
        from transfusion_tpu.models.fusion import CrossFusionLevel, EncoderLayer
        from transfusion_tpu.models.fusion_variants import VisualFeatureFusion

        c = self.cfg
        shared = tuple(EncoderLayer(D, HEADS, c.ff_multiplier, c.token_dropout, c.activation,
                                    name=f"shared_layer_{i}") for i in range(self.shared)) or None
        vf = VisualFeatureFusion(D, num_layers=1, num_heads=HEADS, name="vis_fusion_0") if self.vis else None
        self.level = CrossFusionLevel(c, self.out_channels, shared_layers=shared, vis_fusion=vf,
                                      name="fusion_0")

    def __call__(self, feat, lang, mask, vf=None):
        return self.level(feat, lang, mask, True, vf)


class _TLevelHost(torch.nn.Module):
    """The port's statement of a level on the model: patch conv and
    back-projection beside it, the shared stack and clip fusion by name."""

    def __init__(self, level, c, patch_hw, shared=None, vis_fusion=None):
        from transfusion_torch.models.fusion import RegroupPatches

        super().__init__()
        ph, pw = patch_hw
        self.patches_to_token = torch.nn.ModuleList([torch.nn.Conv2d(c, D, patch_hw, patch_hw, bias=False)])
        self.tokens_to_features = torch.nn.ModuleList([RegroupPatches(D, c, ph, pw)])
        self.cross_fusion_encoders = torch.nn.ModuleList([level])
        if shared is not None:
            self.shared_t_encoder = shared
        if vis_fusion is not None:
            self.vis_fusion = torch.nn.ModuleList([vis_fusion])

    def forward(self, feat, lang, mask, vf=None):
        extra = {}
        if hasattr(self, "shared_t_encoder"):
            extra["shared_layers"] = self.shared_t_encoder.layers
        if hasattr(self, "vis_fusion"):
            extra["vis_fusion"] = self.vis_fusion[0]
        return self.cross_fusion_encoders[0](feat, lang, mask, self.patches_to_token[0],
                                             self.tokens_to_features[0], visual_features=vf, **extra)


def _host_state(params: dict) -> dict:
    """The port's names of a _JLevelHost's (or a bare level's) params."""
    sd: dict = {}
    W._fusion(0, params["fusion_0"], sd)
    for j, lay in W._layers("shared_layer", params):
        W._encoder_layer(f"shared_t_encoder.layers.{j}", lay, sd)
    if "vis_fusion_0" in params:
        W._vis_fusion(0, params["vis_fusion_0"], sd)
    return sd


@pytest.mark.parametrize("case", ["relu_no_final_norm", "shared_sin2d_local", "clip_features"])
def test_cross_fusion_level_matches_jax(case):
    """The fused map and the fused language tokens (lang_out) of one level:
    ReLU with learned positions and no final norm; a two-layer shared stack
    with sin2d positions and a local visual mask; clip features fused with
    the patch tokens first."""
    from transfusion_torch.models.fusion import CrossFusionLevel as TLevel
    from transfusion_torch.models.fusion import EncoderLayer as TLayer, _TEncoder
    from transfusion_torch.models.fusion_variants import VisualFeatureFusion as TVis
    from transfusion_tpu.models.fusion import FusionLevelConfig

    opts = {"relu_no_final_norm": dict(activation="relu", final_norm="none", pos_embedding="learned"),
            "shared_sin2d_local": dict(pos_embedding="sin2d", vis_mask_type="local_1"),
            "clip_features": dict()}[case]
    shared = 2 if case == "shared_sin2d_local" else 0
    vis = case == "clip_features"
    jcfg = FusionLevelConfig(token_dim=D, num_layers=1, num_heads=HEADS, patch_h=2, patch_w=2, **opts)
    feat, lang, mask = _inputs(3)
    clip = np.random.default_rng(4).normal(0, 1, (2, 3, 40)).astype(np.float32) if vis else None
    host = _JLevelHost(jcfg, 8, shared, vis)
    args = (jnp.asarray(feat), jnp.asarray(lang), jnp.asarray(mask), None if clip is None else jnp.asarray(clip))
    params = host.init(jax.random.key(2), *args)["params"]
    ref_map, ref_lang = host.apply({"params": params}, *args)

    level = TLevel(D, 0 if shared else 1, HEADS, 2.0, (2, 2), jcfg.vis_mask_type,
                   pos_embedding=jcfg.pos_embedding, final_norm=jcfg.final_norm, activation=jcfg.activation)
    t_shared = _TEncoder([TLayer(D, HEADS) for _ in range(shared)]) if shared else None
    t_vis = TVis(D, 40, num_layers=1, num_heads=HEADS) if vis else None
    port = _load(_TLevelHost(level, 8, (2, 2), t_shared, t_vis), _host_state(params))
    with torch.no_grad():
        got_map, got_lang = port(_nchw(feat), _t(lang), _t(mask), None if clip is None else _t(clip))
    _close(got_map.permute(0, 2, 3, 1), ref_map, msg="fused map")
    _close(got_lang, ref_lang, msg="lang_out")


def test_qkv_encoder_layer_matches_jax():
    """Queries against a padded memory of another length, ReLU, ff 1."""
    from transfusion_torch.models.fusion_variants import QKVEncoderLayer as TQKV
    from transfusion_tpu.models.fusion_variants import QKVEncoderLayer as JQKV

    rng = np.random.default_rng(5)
    q = rng.normal(0, 1, (2, 5, D)).astype(np.float32)
    mem = rng.normal(0, 1, (2, 9, D)).astype(np.float32)
    pad = np.zeros((2, 9), bool)
    pad[1, 6:] = True
    jm = JQKV(D, HEADS, dropout=0.0)
    params = jm.init(jax.random.key(0), jnp.asarray(q), jnp.asarray(mem), jnp.asarray(pad))["params"]
    ref = jm.apply({"params": params}, jnp.asarray(q), jnp.asarray(mem), jnp.asarray(pad))
    sd: dict = {}
    for p in ("q_proj", "k_proj", "v_proj", "out_proj", "linear1", "linear2"):
        W._dense(sd, p, params[p])
    for p in ("norm1", "norm2"):
        W._norm(sd, p, params[p])
    tm = _load(TQKV(D, HEADS), sd)
    with torch.no_grad():
        _close(tm(_t(q), _t(mem), _t(pad)), ref)


def test_asymmetric_level_matches_jax():
    """Three visual and two language QKV layers (language first in the first
    pair, the memory re-concatenated between layers), zero positions."""
    from transfusion_torch.models.fusion_variants import AsymmetricCrossFusionLevel as TAsym
    from transfusion_tpu.models.fusion_variants import AsymmetricConfig, AsymmetricCrossFusionLevel

    cfg = AsymmetricConfig(token_dim=D, vis_layers=3, lang_layers=2, num_heads=HEADS, patch_h=2,
                           patch_w=2, pos_embedding="zero")
    feat, lang, mask = _inputs(6)
    jm = AsymmetricCrossFusionLevel(cfg, 8)
    args = (jnp.asarray(feat), jnp.asarray(lang), jnp.asarray(mask))
    params = jm.init(jax.random.key(1), *args)["params"]
    # Make the zero positions non-zero so that their mapping is checked.
    params = dict(params, pos={"pos_embedding": jax.random.normal(jax.random.key(9), (8192, D))})
    ref_map, ref_lang = jm.apply({"params": params}, *args)
    level = TAsym(D, 3, 2, HEADS, 1.0, (2, 2), pos_embedding="zero")
    port = _load(_TLevelHost(level, 8, (2, 2)), _host_state({"fusion_0": params}))
    with torch.no_grad():
        got_map, got_lang = port(_nchw(feat), _t(lang), _t(mask))
    _close(got_map.permute(0, 2, 3, 1), ref_map, msg="fused map")
    _close(got_lang, ref_lang, msg="lang_out")


@pytest.mark.parametrize("which", ["qkv_layer", "space_time_module"])
def test_flax_norms_take_an_f32_stream_at_bf16_compute(which):
    """Where JAX uses flax's LayerNorm (the QKV layer's norms, the space-time
    final norm), an f32 input is summed and normalised in f32 and only the
    output is rounded to bf16. The input rides on an offset of 256, where a
    bf16 ulp is 2: rounding it first would lose the N(0, 1) signal. bf16
    compute on both sides: rtol 2e-2 / atol 5e-2, a few bf16 ulps of the
    normalised output."""
    from transfusion_torch.models import fusion_variants as tv
    from transfusion_tpu.models import fusion_variants as jv

    rng = np.random.default_rng(11)
    if which == "qkv_layer":
        x = (256.0 + rng.normal(0, 1, (2, 5, D))).astype(np.float32)
        mem = rng.normal(0, 1, (2, 9, D)).astype(np.float32)
        jm = jv.QKVEncoderLayer(D, HEADS, dropout=0.0, dtype=jnp.bfloat16)
        args = (jnp.asarray(x), jnp.asarray(mem).astype(jnp.bfloat16))
        params = jm.init(jax.random.key(0), *args)["params"]
        sd: dict = {}
        for p in ("q_proj", "k_proj", "v_proj", "out_proj", "linear1", "linear2"):
            W._dense(sd, p, params[p])
        for p in ("norm1", "norm2"):
            W._norm(sd, p, params[p])
        tm = _load(tv.QKVEncoderLayer(D, HEADS, dtype=torch.bfloat16), sd)
        targs = (_t(x), _t(mem).to(torch.bfloat16))
    else:
        x = (256.0 + rng.normal(0, 1, (2, 3, 5, D))).astype(np.float32)
        jm = jv.SpaceTimeFusionModule(D, num_layers=2, num_heads=HEADS, dtype=jnp.bfloat16)
        args = (jnp.asarray(x),)
        params = jm.init(jax.random.key(4), *args)["params"]
        sd = {}
        W._fusion(0, {"encoder": params, "patch_to_token": {"kernel": np.zeros((1, 1, 1, D))},
                      "back_proj": {"kernel": np.zeros((D, 1)), "bias": np.zeros(1)}}, sd)
        prefix = "cross_fusion_encoders.0.encoder."
        tm = _load(tv.SpaceTimeFusionModule(D, num_layers=2, num_heads=HEADS, dtype=torch.bfloat16),
                   {k.removeprefix(prefix): v for k, v in sd.items() if k.startswith(prefix)})
        targs = (_t(x),)
    ref = jm.apply({"params": params}, *args)
    with torch.no_grad():
        got = tm(*targs)
    assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    _close(got, np.asarray(ref.astype(jnp.float32)), rtol=2e-2, atol=5e-2)


@pytest.mark.parametrize("which", ["layer", "module", "level"])
def test_space_time_matches_jax(which):
    """SpaceTimeFusionLayer and SpaceTimeFusionModule on a T != S grid
    [2, 3, 5, D], and the level on a map patched into a 4 x 6 grid (the
    language passes through)."""
    from transfusion_torch.models import fusion_variants as tv
    from transfusion_tpu.models import fusion_variants as jv
    from transfusion_tpu.models.fusion import FusionLevelConfig

    x = np.random.default_rng(7).normal(0, 1, (2, 3, 5, D)).astype(np.float32)
    if which == "level":
        jcfg = FusionLevelConfig(token_dim=D, num_layers=2, num_heads=HEADS, patch_h=2, patch_w=2,
                                 activation="relu", pos_embedding="learned")
        feat, lang, mask = _inputs(8)
        jm = jv.SpaceTimeFusionLevel(jcfg, 8)
        args = (jnp.asarray(feat), jnp.asarray(lang), jnp.asarray(mask))
        params = jm.init(jax.random.key(3), *args)["params"]
        ref_map, ref_lang = jm.apply({"params": params}, *args)
        level = tv.SpaceTimeFusionLevel(D, 2, HEADS, 2.0, (2, 2), pos_embedding="learned")
        port = _load(_TLevelHost(level, 8, (2, 2)), _host_state({"fusion_0": params}))
        with torch.no_grad():
            got_map, got_lang = port(_nchw(feat), _t(lang), _t(mask))
        _close(got_map.permute(0, 2, 3, 1), ref_map, msg="fused map")
        np.testing.assert_array_equal(got_lang.numpy(), lang)
        return
    if which == "layer":
        jm, tm = jv.SpaceTimeFusionLayer(D, HEADS, dropout=0.0), tv.SpaceTimeFusionLayer(D, HEADS)
    else:
        jm = jv.SpaceTimeFusionModule(D, num_layers=2, num_heads=HEADS)
        tm = tv.SpaceTimeFusionModule(D, num_layers=2, num_heads=HEADS)
    params = jm.init(jax.random.key(4), jnp.asarray(x))["params"]
    ref = jm.apply({"params": params}, jnp.asarray(x))
    # The module's tree as a space-time level's encoder subtree.
    sd: dict = {}
    tree = params if which == "module" else {"image_kind": np.zeros((1, 1, 1, D)), "layer_0": params}
    W._fusion(0, {"encoder": tree, "patch_to_token": {"kernel": np.zeros((1, 1, 1, D))},
                  "back_proj": {"kernel": np.zeros((D, 1)), "bias": np.zeros(1)}}, sd)
    prefix = "cross_fusion_encoders.0.encoder." + ("" if which == "module" else "layers.0.")
    _load(tm, {k.removeprefix(prefix): v for k, v in sd.items() if k.startswith(prefix)})
    with torch.no_grad():
        _close(tm(_t(x)), ref)


def test_visual_feature_fusion_matches_jax():
    """Clip features [2, 6, 2304] L2-normalised, projected, learned
    positions, two GELU layers jointly with 24 patch tokens: both halves."""
    from transfusion_torch.models.fusion_variants import VisualFeatureFusion as TVis
    from transfusion_tpu.models.fusion_variants import VisualFeatureFusion as JVis

    rng = np.random.default_rng(9)
    patches = rng.normal(0, 1, (2, 24, D)).astype(np.float32)
    clip = rng.normal(0, 1, (2, 6, 2304)).astype(np.float32)
    clip[1, 0] = 0.0  # a zero feature: the norm clip at 1e-12
    jm = JVis(D, num_layers=2, num_heads=HEADS)
    params = jm.init(jax.random.key(5), jnp.asarray(patches), jnp.asarray(clip))["params"]
    ref = jm.apply({"params": params}, jnp.asarray(patches), jnp.asarray(clip))
    sd: dict = {}
    W._vis_fusion(0, params, sd)
    tm = _load(TVis(D, 2304, num_layers=2, num_heads=HEADS), {k.removeprefix("vis_fusion.0."): v
                                                               for k, v in sd.items()})
    with torch.no_grad():
        got = tm(_t(patches), _t(clip))
    for a, b, name in zip(got, ref, ("patch half", "clip half")):
        _close(a, b, msg=name)


def test_narration_embedding_mode_matches_jax():
    """out_mode "embedding": the masked mean of the BERT tokens,
    L2-normalised, through out_mlp."""
    from transfusion_torch.models.text_encoder import BertConfig as TBert, NarrationEncoder as TNarr
    from transfusion_tpu.models.text_encoder import BertConfig as JBert, NarrationEncoder as JNarr

    kw = dict(vocab_size=64, hidden_size=16, num_layers=1, num_heads=2, intermediate_size=32,
              max_position_embeddings=16)
    rng = np.random.default_rng(10)
    ids = rng.integers(0, 64, (2, 8)).astype(np.int32)
    mask = np.ones((2, 8), np.int32)
    mask[1, 5:] = 0
    jm = JNarr(JBert(**kw), out_mode="embedding", out_mlp=D)
    params = jm.init(jax.random.key(6), jnp.asarray(ids), jnp.asarray(mask))["params"]
    ref, _ = jm.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask))
    sd: dict = {}
    W._bert(params["bert"], sd)
    W._dense(sd, "narr_pooling_layer.out_mlp", params["out_mlp"])
    tm = _load(TNarr(TBert(**kw), D, out_mode="embedding"),
               {k.removeprefix("narr_pooling_layer."): v for k, v in sd.items()})
    with torch.no_grad():
        got, _ = tm(_t(ids).long(), _t(mask))
    assert got.shape == (2, D)
    _close(got, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("pooling, use_ln", [("mean", True), ("mean", False), ("max", True), ("max", False)])
def test_pool_predictor_matches_jax(pooling, use_ln):
    """Masked tokens zeroed, then mean over all L or max (negative tokens,
    so a zeroed pad wins the max), LayerNorm or not, noun and verb logits."""
    from transfusion_torch.models.fusion import PoolPredictor as TPool
    from transfusion_tpu.models.fusion import PoolPredictor as JPool

    rng = np.random.default_rng(11)
    x = rng.normal(0, 1, (3, 6, D)).astype(np.float32)
    x[2] = -np.abs(x[2]) - 0.5
    mask = np.ones((3, 6), bool)
    mask[1, 4:] = mask[2, 3:] = False
    jm = JPool(6, 4, pooling, use_ln)
    params = jm.init(jax.random.key(7), jnp.asarray(x), jnp.asarray(mask))["params"]
    ref = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask))
    sd: dict = {}
    W._lm_head("lm", params, sd)
    tm = _load(TPool(D, 6, 4, pooling, use_ln), {k.removeprefix("lm."): v for k, v in sd.items()})
    with torch.no_grad():
        got = tm(_t(x), _t(mask))
    for key in ("noun_logits", "verb_logits"):
        _close(got[key], ref[key], msg=key)


@pytest.mark.parametrize("verbs", [True, False])
def test_lm_loss_matches_jax(verbs):
    """Value and gradient against jax.grad, with the moved class
    (last_noun_idx -> 0), out-of-range targets (clipped) and the verb-less
    head."""
    from transfusion_torch.train.losses import lm_loss as t_loss
    from transfusion_tpu.train.losses import lm_loss as j_loss

    rng = np.random.default_rng(12)
    noun = rng.normal(0, 2, (4, 6)).astype(np.float32)
    verb = rng.normal(0, 2, (4, 4)).astype(np.float32)
    targets = {"nouns": np.array([[2, 1], [6, 0], [9, 3], [0, 0]]),
               "verbs": np.array([[1, 0], [999, 2], [3, 3], [0, 1]])}
    jt = {k: jnp.asarray(v) for k, v in targets.items()}

    def jfn(n, v):
        return j_loss({"noun_logits": n, "verb_logits": v if verbs else None}, jt, 6)

    ref, (gn, gv) = jax.value_and_grad(jfn, argnums=(0, 1))(jnp.asarray(noun), jnp.asarray(verb))
    tn, tv_ = _t(noun).requires_grad_(), _t(verb).requires_grad_()
    got = t_loss({"noun_logits": tn, "verb_logits": tv_ if verbs else None},
                 {k: _t(v) for k, v in targets.items()}, 6)
    got.backward()
    _close(got, ref, rtol=1e-6, atol=1e-6)
    _close(tn.grad, gn, rtol=1e-5, atol=1e-6)
    if verbs:
        _close(tv_.grad, gv, rtol=1e-5, atol=1e-6)
    else:
        assert tv_.grad is None


# --------------------------------------------------------- whole models
def _cfg(pkg: str, fusion: dict, **top):
    """The golden tiny model's configuration (tests/test_golden_detections.py)
    in either package, with fusion and model options."""
    mods = __import__(f"transfusion_{pkg}.models", fromlist=["detector", "roi_heads", "rpn",
                                                             "text_encoder", "transfusion"])
    tf = mods.transfusion
    return tf.TransFusionConfig(
        detector=mods.detector.DetectorConfig(
            roi=mods.roi_heads.RoIConfig(num_nouns=7, num_verbs=5, representation_size=64,
                                         batch_size_per_image=16, detections_per_img=10,
                                         score_thresh=0.01, ttc_on=True, additional_postprocessing=True),
            rpn=mods.rpn.RPNConfig(pre_nms_top_n_test=64, post_nms_top_n_test=32, score_thresh=0.01),
            stage_sizes=(1, 1, 1, 1)),
        fusion=tf.FusionConfig(**{"fpn_features": (2, 3), "patch_h": (2, 1), "patch_w": (2, 1),
                                  "num_layers": (1, 1), "token_dim": D, "num_heads": HEADS, **fusion}),
        bert=mods.text_encoder.BertConfig(vocab_size=64, hidden_size=16, num_layers=1, num_heads=2,
                                          intermediate_size=32, max_position_embeddings=16),
        out_mlp=D, **top)


# The five families of chip_smoke.py's fusion-options phase, tiny: (fusion
# options, model options).
FAMILIES = {
    "lm": ({}, dict(lm_on=True, lm_use_f=True)),
    "shared_sum_sep": (dict(share_encoders=True, forward_language_f="sum", pos_embedding="learned"),
                       dict(lm_on=True, lm_multi="sep")),
    "asymmetric": (dict(fusion_type="asymmetric", num_layers=(2, 2), asymm_lang_layers=1),
                   dict(lm_on=True, lm_multi=True)),
    "space_time": (dict(fusion_type="space_time", activation="relu"), {}),
    "vis_lang": (dict(forward_language_f="direct"),
                 dict(use_visual_features=True, visual_feature_layers=1, narr_out_mode="embedding")),
}
# The whole-model parity cases: the JAX CLI's LM config, and a combination
# of shared stack, summed language, per-level heads, learned positions,
# clip features and embedding mode.
WHOLE = {
    "cli_lm": FAMILIES["lm"],
    "shared_sum_sep_clip_embedding": (
        dict(share_encoders=True, forward_language_f="sum", pos_embedding="learned"),
        dict(lm_on=True, lm_multi="sep", use_visual_features=True, visual_feature_layers=1,
             narr_out_mode="embedding")),
}
CLIP_T, CLIP_F = 4, 2304


def _batch(h=96, w=128):
    rng = np.random.default_rng(13)
    mask = np.ones((2, 8), np.int32)
    mask[1, 6:] = 0
    return {"image": rng.normal(0.3, 0.6, (2, h, w, 3)).astype(np.float32),
            "input_ids": rng.integers(0, 64, (2, 8)).astype(np.int32), "attention_mask": mask,
            "visual_features": rng.normal(0, 1, (2, CLIP_T, CLIP_F)).astype(np.float32)}


@pytest.mark.parametrize("case", list(WHOLE))
def test_whole_model_matches_jax(case):
    """JAX-initialised weights through state_dict_from_jax (strict); the
    RoI outputs, proposals, LM logits and detections of one eval forward."""
    from transfusion_torch.models.detector import detections_from_outputs as t_dets
    from transfusion_torch.models.transfusion import TransFusion as TModel
    from transfusion_tpu.models.detector import detections_from_outputs as j_dets
    from transfusion_tpu.models.transfusion import TransFusion as JModel

    fusion, top = WHOLE[case]
    jcfg, tcfg = _cfg("tpu", fusion, **top), _cfg("torch", fusion, **top)
    batch, hw = _batch(), (96, 128)
    jmodel = JModel(jcfg)

    def init_apply(key, b):
        b = dict(b, image_hw=hw)
        params = jmodel.init({"params": key}, b, False)
        out = jmodel.apply(params, b, False)
        return params, out, j_dets(out, jcfg.detector)

    # One program, compiled at XLA's lowest backend optimisation level (the
    # same arithmetic, less compile time).
    key = jax.random.key(21)
    compiled = jax.jit(init_apply).lower(key, batch).compile({"xla_backend_optimization_level": 0})
    params, jout, jdets = jax.device_get(compiled(key, batch))
    port = TModel(tcfg, device="cpu")
    port.load_state_dict(state := W.state_dict_from_jax(params), strict=True)
    assert any(k.startswith("lm_layer") for k in state)
    tbatch = {k: _t(v) for k, v in batch.items()}
    tbatch["input_ids"] = tbatch["input_ids"].long()
    tbatch["image_hw"] = hw
    with torch.no_grad():
        out = port(tbatch)
        dets = t_dets(out, tcfg.detector)
    np.testing.assert_array_equal(out["proposals"]["valid"].numpy(), np.asarray(jout["proposals"]["valid"]))
    _close(out["proposals"]["boxes"], jout["proposals"]["boxes"], atol=1e-3, msg="proposal boxes")
    for key in ("class_logits", "verb_logits", "box_regression", "ttcs", "box_features"):
        _close(out["roi_outputs"][key], jout["roi_outputs"][key], msg=key)
    for key in ("noun_logits", "verb_logits"):
        _close(out["lm"][key], jout["lm"][key], msg=f"lm {key}")
    assert set(dets) == set(jdets)
    for key, want in jdets.items():
        want = np.asarray(want)
        if want.dtype.kind == "f":
            _close(dets[key], want, rtol=1e-4, atol=1e-3, msg=key)
        else:
            np.testing.assert_array_equal(dets[key].numpy(), want, err_msg=key)


@functools.cache
def _family_shapes(family: str):
    """The JAX param tree's shapes of a family's tiny model (eval_shape of
    its init: no compile)."""
    from transfusion_tpu.models.transfusion import TransFusion as JModel

    fusion, top = FAMILIES[family]
    jmodel = JModel(_cfg("tpu", fusion, **top))
    batch = jax.tree.map(jnp.asarray, _batch(64, 64))
    if not top.get("use_visual_features"):
        batch.pop("visual_features")
    return jax.eval_shape(lambda k: jmodel.init({"params": k}, dict(batch, image_hw=(64, 64)), False),
                          jax.random.key(0))["params"]


@pytest.mark.parametrize("family", list(FAMILIES))
def test_state_dict_from_jax_fills_every_parameter(family):
    """For each family's tiny model, a JAX param tree of its shapes (filled
    with seeded values) gives a state dict that loads strictly into the
    port and leaves no parameter at its init."""
    from transfusion_torch.models.transfusion import TransFusion as TModel
    from transfusion_torch.weights import init_random_

    fusion, top = FAMILIES[family]
    shapes = _family_shapes(family)
    rng = np.random.default_rng(14)
    tree = jax.tree.map(lambda s: rng.normal(0, 1, s.shape).astype(np.float32) + 3.0, shapes)
    port = init_random_(TModel(_cfg("torch", fusion, **top), device="cpu"), seed=1)
    before = {k: v.clone() for k, v in port.named_parameters()}
    port.load_state_dict(W.state_dict_from_jax(tree), strict=True)
    for name, p in port.named_parameters():
        assert not torch.equal(p, before[name]), name


@pytest.mark.parametrize("family", list(FAMILIES))
def test_new_parameters_take_jax_lr_groups_and_freeze_multipliers(family):
    """The port's name rules (optim.param_group_label, the trainer's
    unfreeze_multipliers) give every parameter of each family, the LM heads,
    shared stack, asymmetric, space-time and clip-fusion layers and learned
    positions included, the group and multiplier JAX's path rules give it
    (mapped through state_dict_from_jax), for three freeze rule sets."""
    from transfusion_torch.models.transfusion import TransFusion as TModel
    from transfusion_torch.runner.trainer import unfreeze_multipliers as t_mult
    from transfusion_torch.train.optim import param_group_label as t_label
    from transfusion_tpu.runner.trainer import unfreeze_multipliers as j_mult
    from transfusion_tpu.train.optim import param_group_label as j_label

    fusion, top = FAMILIES[family]
    shapes = _family_shapes(family)
    names = [n for n, _ in TModel(_cfg("torch", fusion, **top), device="cpu").named_parameters()]
    codes = {"encoder": 1.0, "main": 2.0, "ttc": 3.0}
    filled = jax.tree_util.tree_map_with_path(
        lambda path, x: np.full(x.shape, codes[j_label(path)], np.float32), shapes)
    want = W.state_dict_from_jax(filled)
    for n in names:
        assert np.unique(want[n].numpy()).tolist() == [codes[t_label(n)]], n
    for epoch, mcfg, narr_ep, freeze_at in ((0, {"train_ep": -1, "trainable_layers": 2}, -1, -1),
                                            (2, {"train_ep": 1, "trainable_layers": 5}, 0, -1),
                                            (1, {"train_ep": 0, "trainable_layers": 1}, 0, 1)):
        tree = j_mult(shapes, epoch, mcfg, narr_ep, 1, 1, freeze_at)
        want = W.state_dict_from_jax(jax.tree.map(lambda m, x: np.full(x.shape, m, np.float32), tree, shapes))
        got = t_mult([(n, None) for n in names], epoch, mcfg, narr_ep, 1, 1, freeze_at)
        for n in names:
            assert np.unique(want[n].numpy()).tolist() == [got[n]], (epoch, n)
