"""The port's eval slice against the JAX model, module by module and end to
end, on the CPU (f32). One set of JAX params -- the golden tiny model's,
``jax.random.key(1234)`` -- is carried into the port through
``weights.state_dict_from_jax``; both packages then take the same inputs.
Tolerances: f32 convolution/matmul stacks agree to ~1e-5 relative, so
module outputs are held at rtol 1e-4 / atol 1e-4 (scaled to the
activations' size where noted); detections at the golden test's own
rtol 1e-4 / atol 1e-3 with integers exact."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_golden_detections import GOLDEN, _fixed_batch, _tiny_model
from tests.torch_threads import cap_torch_threads  # noqa: F401
from transfusion_torch.models.detector import DetectorConfig, detections_from_outputs
from transfusion_torch.models.roi_heads import RoIConfig, postprocess_detections
from transfusion_torch.models.rpn import RPNConfig
from transfusion_torch.models.text_encoder import BertConfig, mean_pool
from transfusion_tpu.models.text_encoder import mean_pool as j_mean_pool
from transfusion_torch.models.transfusion import FusionConfig, TransFusion, TransFusionConfig
from transfusion_torch.weights import state_dict_from_jax

FREQS = np.zeros((7, 5), np.float32)
FREQS[1, 2] = 3.0
FREQS[2, 0] = 1.0


def _port_cfg():
    """The port's statement of tests/test_golden_detections.py::_tiny_model."""
    return TransFusionConfig(
        detector=DetectorConfig(
            roi=RoIConfig(num_nouns=7, num_verbs=5, representation_size=64,
                          batch_size_per_image=16, detections_per_img=10, score_thresh=0.01,
                          ttc_on=True, additional_postprocessing=True),
            rpn=RPNConfig(pre_nms_top_n_test=64, post_nms_top_n_test=32, score_thresh=0.01),
            stage_sizes=(1, 1, 1, 1),
        ),
        fusion=FusionConfig(fpn_features=(2, 3), patch_h=(2, 1), patch_w=(2, 1),
                            num_layers=(1, 1), token_dim=32, num_heads=2),
        bert=BertConfig(vocab_size=64, hidden_size=16, num_layers=1, num_heads=2,
                        intermediate_size=32, max_position_embeddings=16),
        out_mlp=32,
    )


@pytest.fixture(scope="module")
def golden():
    model, cfg = _tiny_model()
    batch, hw = _fixed_batch()
    init = jax.jit(lambda k, b: model.init({"params": k}, dict(b, image_hw=hw), False))
    params = jax.device_get(init(jax.random.key(1234), batch))
    port = TransFusion(_port_cfg(), device="cpu")
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    tbatch["image_hw"] = hw
    return {"model": model, "cfg": cfg, "params": params, "batch": batch, "hw": hw,
            "port": port, "tbatch": tbatch}


def _close(got, want, rtol=1e-4, atol=1e-4, msg=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=rtol, atol=atol, err_msg=msg)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


# ----------------------------------------------------------- (d) the modules
def test_backbone_and_fpn_match_jax(golden):
    m, p, b = golden["model"], golden["params"], golden["batch"]
    jfeats = m.apply(p, b["image"], method=lambda mdl, x: mdl.rcnn.forward_features(x))
    with torch.no_grad():
        feats = golden["port"].forward_features(golden["tbatch"]["image"])
    for k in "0123":
        scale = float(np.abs(np.asarray(jfeats[k])).max())
        _close(_nhwc(feats[k]), jfeats[k], atol=1e-5 * scale, msg=k)
    # FPN on the same (JAX) inputs, 'pool' included.
    jfpn = m.apply(p, jfeats, method=lambda mdl, f: mdl.rcnn.apply_fpn(f))
    with torch.no_grad():
        fpn = golden["port"].apply_fpn(
            {k: torch.from_numpy(np.array(v)).permute(0, 3, 1, 2) for k, v in jfeats.items()})
    assert set(fpn) == set(jfpn) == {"0", "1", "2", "3", "pool"}
    for k in jfpn:
        scale = float(np.abs(np.asarray(jfpn[k])).max())
        _close(_nhwc(fpn[k]), jfpn[k], atol=1e-5 * scale, msg=k)


def test_narration_encoder_matches_jax(golden):
    """MiniLM-style encoder + out_mlp with padded tokens (flax LayerNorm
    statistics restated, eps 1e-12)."""
    m, p = golden["model"], golden["params"]
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 64, (2, 8)).astype(np.int32)
    mask = np.ones((2, 8), np.int32)
    mask[1, 5:] = 0
    jtok, _ = m.apply(p, jnp.asarray(ids), jnp.asarray(mask),
                      method=lambda mdl, i, a: mdl.narr_encoder(i, a, deterministic=True))
    with torch.no_grad():
        tok, _ = golden["port"].narr_pooling_layer(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    _close(tok, jtok, rtol=1e-4, atol=1e-5)
    _close(mean_pool(tok, torch.from_numpy(mask)), j_mean_pool(jtok, jnp.asarray(mask)),
           rtol=1e-4, atol=1e-5, msg="mean_pool")


def _encoder_layer_pair(x, pad, attn_mask=None):
    """One fusion EncoderLayer (d 32, 2 heads, use_flash on) in both
    packages with the same weights: returns (JAX output, port output)."""
    from transfusion_torch.models.fusion import EncoderLayer as TLayer
    from transfusion_tpu.models.fusion import EncoderLayer as JLayer

    d = x.shape[-1]
    jmask = None if attn_mask is None else jnp.asarray(attn_mask)
    jl = JLayer(d, 2, use_flash=True)
    params = jl.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(pad), jmask)["params"]
    ref = jl.apply({"params": params}, jnp.asarray(x), jnp.asarray(pad), jmask)

    tl = TLayer(d, 2, use_flash=True).eval()  # deterministic, as the JAX layer's default
    lin = lambda n: np.asarray(params[n]["kernel"]).T  # noqa: E731
    sd = {
        "self_attn.in_proj_weight": np.concatenate([lin(n) for n in ("q_proj", "k_proj", "v_proj")]),
        "self_attn.in_proj_bias": np.concatenate(
            [np.asarray(params[n]["bias"]) for n in ("q_proj", "k_proj", "v_proj")]),
        "self_attn.out_proj.weight": lin("out_proj"),
        "self_attn.out_proj.bias": np.asarray(params["out_proj"]["bias"]),
    }
    for n in ("linear1", "linear2"):
        sd[f"{n}.weight"], sd[f"{n}.bias"] = lin(n), np.asarray(params[n]["bias"])
    for n in ("norm1", "norm2"):
        sd[f"{n}.weight"], sd[f"{n}.bias"] = np.asarray(params[n]["scale"]), np.asarray(params[n]["bias"])
    tl.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = tl(torch.from_numpy(x), key_padding_mask=torch.from_numpy(pad),
                 attn_mask=None if attn_mask is None else torch.from_numpy(attn_mask))
    return ref, got


def test_encoder_layer_kernel_gate_matches_jax():
    """EncoderLayer at l >= 2048 with use_flash on, d 32, 2 heads: both
    packages take their attention kernel's path (JAX: Pallas in interpret
    mode; port: the kernel wrapper's plain version) and the LN kernels'."""
    rng = np.random.default_rng(5)
    l, d = 2050, 32
    x = rng.normal(0, 1, (1, l, d)).astype(np.float32)
    pad = np.zeros((1, l), bool)
    pad[0, -3:] = True
    ref, got = _encoder_layer_pair(x, pad)
    _close(got, ref, rtol=1e-4, atol=1e-4)


def test_local_visual_mask_matches_jax():
    """visual_token_mask for every kind, and an EncoderLayer under a local_1
    joint mask (visual tokens see their 3x3 window and the language tokens):
    the mask sends both packages down the plain attention path."""
    from transfusion_torch.models.fusion import visual_token_mask as t_mask
    from transfusion_tpu.models.fusion import visual_token_mask as j_mask

    gh, gw, n_lang = 4, 6, 5
    assert t_mask(gh, gw, "global") is None and j_mask(gh, gw, "global") is None
    for kind in ("local_1", "local_2"):
        np.testing.assert_array_equal(t_mask(gh, gw, kind), j_mask(gh, gw, kind))
    n = gh * gw
    joint = np.zeros((n + n_lang, n + n_lang), bool)
    joint[:n, :n] = t_mask(gh, gw, "local_1")
    rng = np.random.default_rng(6)
    x = rng.normal(0, 1, (2, n + n_lang, 32)).astype(np.float32)
    pad = np.zeros((2, n + n_lang), bool)
    pad[1, -2:] = True
    ref, got = _encoder_layer_pair(x, pad, joint)
    _close(got, ref, rtol=1e-4, atol=1e-4)


def test_rpn_roi_and_postprocess_match_jax_slot_by_slot(golden):
    """RPN proposals (static slots, exact validity) and RoI outputs from the
    same FPN maps, then postprocess_detections on the same raw outputs."""
    m, p, hw = golden["model"], golden["params"], golden["hw"]
    trunk = jax.jit(lambda p, b: m.apply(p, b, method=lambda mdl, b: mdl._trunk(dict(b, image_hw=hw), False)[0]))
    jfpn = trunk(p, golden["batch"])
    jout = m.apply(p, jfpn, method=lambda mdl, f: mdl.rcnn.apply_rpn_roi(f, hw, None, False))
    with torch.no_grad():
        out = golden["port"].apply_rpn_roi(
            {k: torch.from_numpy(np.array(v)).permute(0, 3, 1, 2) for k, v in jfpn.items()}, hw)
    jp, tp = jout["proposals"], out["proposals"]
    np.testing.assert_array_equal(tp["valid"].numpy(), np.asarray(jp["valid"]))
    _close(tp["boxes"], jp["boxes"], rtol=1e-4, atol=1e-3, msg="proposal boxes")
    _close(tp["scores"], jp["scores"], rtol=1e-4, atol=1e-5, msg="proposal scores")
    for key in ("class_logits", "verb_logits", "box_regression", "ttcs", "box_features"):
        _close(out["roi_outputs"][key], jout["roi_outputs"][key], rtol=1e-4, atol=1e-4, msg=key)

    from transfusion_tpu.models.roi_heads import postprocess_detections as j_post

    jr = jout["roi_outputs"]
    ref = j_post(jr, jr["proposals"], jr["proposals_valid"], hw, golden["cfg"].detector.roi,
                 noun_verb_frequencies=jnp.asarray(FREQS))
    tr = {k: torch.from_numpy(np.asarray(v)) for k, v in jr.items()}
    got = postprocess_detections(tr, tr["proposals"], tr["proposals_valid"], hw,
                                 _port_cfg().detector.roi, noun_verb_frequencies=torch.from_numpy(FREQS))
    assert set(got) == set(ref)
    for key in ref:
        want = np.asarray(ref[key])
        if want.dtype.kind == "f":
            _close(got[key], want, rtol=1e-4, atol=1e-3, msg=key)
        else:
            np.testing.assert_array_equal(got[key].numpy(), want, err_msg=key)


# ---------------------------------------------------------- (e) the slice
def test_port_reproduces_golden_detections(golden):
    """JAX-initialised weights through state_dict_from_jax; the port's eval
    forward + detections_from_outputs gives tests/golden/tiny_detections.npz."""
    with torch.no_grad():
        dets = detections_from_outputs(golden["port"](golden["tbatch"]), _port_cfg().detector,
                                       noun_verb_frequencies=torch.from_numpy(FREQS))
    want = np.load(GOLDEN)
    assert set(want.files) == set(dets)
    assert want["valid"].any()
    for key in want.files:
        got = dets[key].numpy()
        assert got.shape == want[key].shape, key
        if want[key].dtype.kind in "fc":
            np.testing.assert_allclose(got, want[key], rtol=1e-4, atol=1e-3, err_msg=key)
        else:
            np.testing.assert_array_equal(got, want[key], err_msg=key)


# ------------------------------------------------------ (f) the round trip
def test_state_dict_round_trips_through_the_translator(golden):
    """translate_reference_checkpoint(port.state_dict()) rebuilds the JAX
    params exactly: every key translated, none left over."""
    from transfusion_tpu.tools.translate_checkpoint import translate_reference_checkpoint

    params = golden["params"]["params"]
    template = jax.tree.map(np.zeros_like, params)
    tree, report = translate_reference_checkpoint(
        golden["port"].state_dict(), template, fpn_features=(2, 3), patch_hw=((2, 2), (1, 1)))
    assert not report["unmatched_source"], report["unmatched_source"]
    assert not report["missing_target"] and not report["shape_mismatch"]
    assert report["translated"] == len(jax.tree.leaves(params))
    flat_want = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_got = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    for path, want in flat_want:
        np.testing.assert_array_equal(np.asarray(flat_got[path]), np.asarray(want), err_msg=str(path))


def test_lm_head_state_dict_round_trips_through_the_translator(golden):
    """With the LM head on, the port's lm_layer.{ln,mlp_noun,mlp_verb}
    cross into the JAX tree through translate_reference_checkpoint (every
    key translated, none left over) and back through state_dict_from_jax,
    bit for bit."""
    import dataclasses

    from transfusion_torch.weights import init_random_
    from transfusion_tpu.tools.translate_checkpoint import translate_reference_checkpoint

    jmodel = type(golden["model"])(dataclasses.replace(golden["cfg"], lm_on=True))
    batch = dict(golden["batch"], image_hw=golden["hw"])
    shapes = jax.eval_shape(lambda k: jmodel.init({"params": k}, batch, False), jax.random.key(0))["params"]
    assert set(shapes["lm_layer"]) == {"ln", "mlp_noun", "mlp_verb"}
    port = init_random_(TransFusion(dataclasses.replace(_port_cfg(), lm_on=True), device="cpu"), seed=2)
    tree, report = translate_reference_checkpoint(
        port.state_dict(), jax.tree.map(lambda x: np.zeros(x.shape, x.dtype), shapes),
        fpn_features=(2, 3), patch_hw=((2, 2), (1, 1)))
    assert not report["unmatched_source"] and not report["missing_target"] and not report["shape_mismatch"]
    assert report["translated"] == len(jax.tree.leaves(shapes))
    back = state_dict_from_jax(tree)
    want = port.state_dict()
    assert set(back) == set(want)
    for k, v in back.items():
        assert torch.equal(v, want[k]), k


def test_state_dict_from_jax_refuses_the_s2d_stem(golden):
    """The s2d stem, once refused, is ported: the golden params with their
    stem folded by JAX's fold_stem_to_s2d (stem_s2d + stem_bn, as the
    translator stages an s2d target) load strictly into the port's s2d
    model, which reproduces the golden detections."""
    from transfusion_tpu.models.resnet import fold_stem_to_s2d

    params = jax.tree.map(np.asarray, golden["params"]["params"])
    bb = dict(params["rcnn"]["backbone"])
    stem = bb.pop("stem")
    bb["stem_s2d"] = {"kernel": fold_stem_to_s2d(stem["conv"]["kernel"])}
    bb["stem_bn"] = dict(stem["bn"])
    s2d = dict(params, rcnn=dict(params["rcnn"], backbone=bb))
    cfg = _port_cfg()
    cfg = dataclasses.replace(cfg, detector=dataclasses.replace(cfg.detector, s2d_stem=True))
    port = TransFusion(cfg, device="cpu")
    port.load_state_dict(state_dict_from_jax(s2d), strict=True)
    assert "backbone.body.stem_s2d.weight" in port.state_dict()
    with torch.no_grad():
        dets = detections_from_outputs(port(golden["tbatch"]), cfg.detector,
                                       noun_verb_frequencies=torch.from_numpy(FREQS))
    want = np.load(GOLDEN)
    assert want["valid"].any()
    for key in want.files:
        if want[key].dtype.kind in "fc":
            np.testing.assert_allclose(dets[key].numpy(), want[key], rtol=1e-4, atol=1e-3, err_msg=key)
        else:
            np.testing.assert_array_equal(dets[key].numpy(), want[key], err_msg=key)
