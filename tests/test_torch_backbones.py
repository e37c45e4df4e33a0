"""The port's other backbones against the JAX package's, on the CPU: the
space-to-depth stem and its fold, whole detectors over MobileNetV3-Large
and the dual-stream (RGB + flow) ResNet, a tiny TransFusion with
``model.type: mobilenet`` built through ``build_transfusion_config``, and
the CLI training and evaluating a MobileNet config. The MobileNet blocks,
trunk and freeze rules are in tests/test_torch_mobilenet.py, the
dual-stream blocks, trunk and flow decoder in
tests/test_torch_dual_stream.py (files of fewer tests, which the suite's
scheduler hands out after its long JAX files); the helpers here serve all
three.

JAX params come from ``eval_shape`` filled from a numpy seed
(``tests/test_torch_language_paths.py::fill``) and cross into the port
through ``weights.state_dict_from_jax``; no JAX init and no JAX step is
compiled. Sizes: 64x96 images, stage sizes (1, 1, 1, 1), MobileNet at its
own widths. Tolerances (f32): the fold exactly; backbone maps at 1e-5
(ResNet) and 2e-5 (MobileNet and dual-stream blocks, as
tests/test_backbone.py:171) relative to the output's largest magnitude
(at least 1); RoI outputs and detections as
tests/test_torch_language_paths.py (RoI outputs rtol 1e-4 / atol 1e-4 of
the largest magnitude, detections rtol 1e-4 / atol 1e-3, integers exact).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_config_data import _fields_match
from tests.test_torch_language_paths import fill
from tests.torch_threads import cap_torch_threads  # noqa: F401
from transfusion_torch import weights as W

HW = (64, 96)


def _t(x):
    return torch.from_numpy(np.array(x))


def _nchw(x):
    return _t(x).permute(0, 3, 1, 2)


def _image(seed=0, b=2, c=3, hw=HW):
    return np.random.default_rng(seed).normal(0.2, 0.7, (b, *hw, c)).astype(np.float32)


def _close_maps(got, want, tol, msg=""):
    """Port NCHW against JAX NHWC, within ``tol`` of the largest magnitude
    (at least 1) and ``tol`` relative."""
    want = np.asarray(want)
    got = got.detach().float().permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * max(float(np.abs(want).max()), 1.0),
                               err_msg=msg)


def _jax_apply(module, variables, *args):
    return jax.device_get(jax.jit(module.apply)(variables, *args))


def _filled(module, *args, seed=5):
    """A JAX module's variables from eval_shape, filled from a seed."""
    shapes = jax.eval_shape(lambda k: module.init(k, *args), jax.random.key(0))
    return fill(dict(shapes), seed)


def _body_state(variables):
    return W.resnet_state_dict_from_jax(variables["params"], variables.get("batch_stats"))


# ------------------------------------------------------------ the s2d stem
def test_fold_matches_jax():
    """The copied fold gives JAX's folded weights exactly, and in the port's
    layout (OIHW) the same numbers."""
    from transfusion_torch.models.resnet import fold_stem_to_s2d, fold_stem_weight
    from transfusion_tpu.models.resnet import fold_stem_to_s2d as j_fold

    w = np.random.default_rng(3).normal(0, 1, (7, 7, 3, 64)).astype(np.float32)
    want = j_fold(w)
    np.testing.assert_array_equal(fold_stem_to_s2d(w), want)
    got = fold_stem_weight(_t(w.transpose(3, 2, 0, 1)))
    np.testing.assert_array_equal(got.numpy(), want.transpose(3, 2, 0, 1))
    assert got.shape == (64, 12, 4, 4)


@pytest.mark.parametrize("trainable_bn", [False, True], ids=["frozen", "trainable"])
def test_s2d_resnet_matches_jax(trainable_bn):
    """JAX's s2d ResNet (stem_s2d + stem_bn, frozen or trainable BN in eval)
    against the port's, weights through state_dict_from_jax."""
    from transfusion_torch.models.resnet import ResNet
    from transfusion_tpu.models.resnet import ResNet as JResNet

    x = _image(1)
    jm = JResNet(stage_sizes=(1, 1, 1, 1), s2d_stem=True, trainable_bn=trainable_bn)
    variables = _filled(jm, jnp.asarray(x))
    assert "stem_s2d" in variables["params"] and "stem_bn" in {**variables["params"],
                                                               **variables.get("batch_stats", {})}
    want = _jax_apply(jm, variables, jnp.asarray(x))
    port = ResNet((1, 1, 1, 1), s2d_stem=True, trainable_bn=trainable_bn)
    port.load_state_dict(_body_state(variables), strict=True)
    with torch.no_grad():
        got = port.eval()(_nchw(x))
    for k in want:
        _close_maps(got[k], want[k], 1e-5, k)


def test_s2d_stem_matches_the_plain_stem_with_folded_weights():
    """A plain-stem detector's state dict folded by weights.fold_plain_stem
    (a reference checkpoint into an s2d model) loads strictly into the s2d
    detector, whose backbone maps equal the plain one's."""
    from transfusion_torch.models.detector import DetectorConfig, FasterRCNN

    cfg = DetectorConfig(stage_sizes=(1, 1, 1, 1))
    plain = W.init_random_(FasterRCNN(cfg, device="cpu"), seed=4)
    with torch.no_grad():
        plain.backbone.body.bn1.running_mean.normal_(0, 0.3)
    s2d = FasterRCNN(dataclasses.replace(cfg, s2d_stem=True), device="cpu")
    s2d.load_state_dict(W.fold_plain_stem(plain.state_dict()), strict=True)
    x = _t(_image(2))
    with torch.no_grad():
        want, got = plain.forward_features(x), s2d.forward_features(x)
    for k in want:
        _close_maps(got[k], want[k].permute(0, 2, 3, 1).numpy(), 1e-5, k)


# ------------------------------------------------------- whole detectors
def _det_cfg(pkg: str, **kw):
    mods = __import__(f"transfusion_{pkg}.models", fromlist=["detector", "roi_heads", "rpn"])
    return mods.detector.DetectorConfig(
        roi=mods.roi_heads.RoIConfig(num_nouns=7, num_verbs=5, representation_size=64,
                                     batch_size_per_image=16, detections_per_img=10,
                                     score_thresh=0.01, ttc_on=True, additional_postprocessing=True),
        rpn=mods.rpn.RPNConfig(pre_nms_top_n_test=64, post_nms_top_n_test=32, score_thresh=0.01),
        stage_sizes=(1, 1, 1, 1), **kw)


def _close_roi(out, jout):
    np.testing.assert_array_equal(out["proposals"]["valid"].numpy(), np.asarray(jout["proposals"]["valid"]))
    np.testing.assert_allclose(out["proposals"]["boxes"].numpy(), np.asarray(jout["proposals"]["boxes"]),
                               rtol=1e-4, atol=1e-3)
    keys = [k for k, v in jout["roi_outputs"].items() if np.asarray(v).dtype.kind == "f"]
    assert {"class_logits", "verb_logits", "box_regression", "box_features"} <= set(keys)
    for key in keys:
        want = np.asarray(jout["roi_outputs"][key])
        np.testing.assert_allclose(out["roi_outputs"][key].numpy(), want, rtol=1e-4,
                                   atol=1e-4 * max(float(np.abs(want).max()), 1.0), err_msg=key)


@pytest.mark.parametrize("kind", ["mobilenet", "dual_stream"])
def test_detector_roi_outputs_match_jax(kind):
    """FasterRCNN with backbone="mobilenet" and with dual_stream=True (a
    seeded flow input): proposals and RoI outputs against JAX's."""
    from transfusion_torch.models.detector import FasterRCNN
    from transfusion_tpu.models.detector import FasterRCNN as JDet

    kw = {"backbone": "mobilenet"} if kind == "mobilenet" else {"dual_stream": True}
    x = _image(14)
    flow = _image(15, c=2) if kind == "dual_stream" else None
    jm = JDet(_det_cfg("tpu", **kw))
    jflow = None if flow is None else jnp.asarray(flow)
    shapes = jax.eval_shape(lambda k: jm.init(k, jnp.asarray(x), HW, None, False, flow=jflow),
                            jax.random.key(0))
    params = fill(shapes["params"], 16)
    run = jax.jit(lambda p, a, f: jm.apply({"params": p}, a, HW, None, False, flow=f))
    jout = jax.device_get(run.lower(params, jnp.asarray(x), jflow).compile(
        {"xla_backend_optimization_level": 0})(params, jnp.asarray(x), jflow))
    port = FasterRCNN(_det_cfg("torch", **kw), device="cpu")
    port.load_state_dict(W.state_dict_from_jax({"rcnn": params}), strict=True)
    with torch.no_grad():
        out = port(_t(x), HW, flow=None if flow is None else _t(flow))
    _close_roi(out, jout)
    if kind == "dual_stream":
        with pytest.raises(ValueError, match="flow"):
            port.forward_features(_t(x))


def _mobilenet_run_config():
    """chip_smoke.py's flagship run config with model.type mobilenet, cut
    to a tiny fusion and MiniLM."""
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    cfg = chip_smoke.flagship_run_config()
    cfg["model"].update(type="mobilenet", representation_size=64)
    run = cfg["run"]
    run["narration_embeds"]["args"].update(model_v="minilm-tiny", out_mlp=32)
    run["narr_fusion"].update(fpn_features=[2, 3], patch_h=[2, 1], patch_w=[2, 1])
    run["narr_fusion"]["args"].update(input_f_size=32, num_layers=[1, 1], num_heads=2)
    return cfg


def test_tiny_mobilenet_transfusion_matches_jax():
    """model.type mobilenet through build_transfusion_config in both
    packages (field by field), then one eval forward and its detections
    against JAX's; the fusion levels take MobileNet's channels. Both models
    keep the golden model's 64 / 32 test-time proposals (the plain RoIAlign
    over the mapping's 1,000 is most of a CPU forward)."""
    from transfusion_torch.models.detector import detections_from_outputs as t_dets
    from transfusion_torch.models.transfusion import TransFusion as TModel
    from transfusion_torch.models.transfusion import build_transfusion_config as t_build
    from transfusion_tpu.models.detector import detections_from_outputs as j_dets
    from transfusion_tpu.models.transfusion import TransFusion as JModel
    from transfusion_tpu.models.transfusion import build_transfusion_config as j_build

    run_cfg = _mobilenet_run_config()
    tcfg, jcfg = t_build(run_cfg, 7, 5), j_build(run_cfg, 7, 5)
    _fields_match(tcfg, jcfg)
    assert tcfg.detector.backbone == "mobilenet"
    tcfg, jcfg = (dataclasses.replace(c, detector=dataclasses.replace(c.detector, rpn=dataclasses.replace(
        c.detector.rpn, pre_nms_top_n_test=64, post_nms_top_n_test=32))) for c in (tcfg, jcfg))
    rng = np.random.default_rng(17)
    mask = np.ones((2, 8), np.int32)
    mask[1, 6:] = 0
    batch = {"image": _image(18), "input_ids": rng.integers(0, 500, (2, 8)).astype(np.int32),
             "attention_mask": mask}
    jmodel = JModel(jcfg)
    shapes = jax.eval_shape(lambda k: jmodel.init({"params": k}, dict(batch, image_hw=HW), False),
                            jax.random.key(0))["params"]
    params = fill(shapes, 19)

    def eval_step(p, b):
        out = jmodel.apply({"params": p}, dict(b, image_hw=HW), False)
        return out, j_dets(out, jcfg.detector)

    jout, jdets = jax.device_get(jax.jit(eval_step).lower(params, batch).compile(
        {"xla_backend_optimization_level": 0})(params, batch))
    port = TModel(tcfg, device="cpu")
    assert port.patches_to_token[0].weight.shape[1] == 80  # level 2's MobileNet channels
    port.load_state_dict(W.state_dict_from_jax(params), strict=True)
    tbatch = {k: _t(v) for k, v in batch.items()}
    tbatch["input_ids"] = tbatch["input_ids"].long()
    tbatch["image_hw"] = HW
    with torch.no_grad():
        out = port(tbatch)
    _close_roi(out, jout)
    dets = t_dets(out, tcfg.detector)
    assert set(dets) == set(jdets)
    for key, want in jdets.items():
        want = np.asarray(want)
        if want.dtype.kind == "f":
            np.testing.assert_allclose(dets[key].numpy(), want, rtol=1e-4, atol=1e-3, err_msg=key)
        else:
            np.testing.assert_array_equal(dets[key].numpy(), want, err_msg=key)


# -------------------------------------------------------------- the CLI
def test_cli_trains_and_evaluates_a_mobilenet_config(tmp_path, monkeypatch, capsys):
    """``python -m transfusion_torch.runner.run_experiment`` on the tiny
    YAMLs with model.type mobilenet: one epoch with validation, the result
    JSON and a checkpoint of the MobileNet body; 64 test-time proposals an
    image (``few_test_proposals``)."""
    from tests.fixtures import make_synthetic_ego4d
    from tests.test_runner_cli import MODEL_CFG, RUN_CFG
    from tests.test_torch_trainer import PORT_FUSION_CFG, few_test_proposals
    from transfusion_torch.runner.run_experiment import main

    few_test_proposals(monkeypatch)

    code, data, runs = tmp_path / "code", tmp_path / "data", tmp_path / "runs"
    code.mkdir()
    make_synthetic_ego4d(os.path.join(str(data), "Ego4d", "v1"), n_train=4, n_val=2, n_test=2,
                         fh=216, fw=288)
    assert "type: res50" in MODEL_CFG
    (code / "mini_model.yml").write_text(MODEL_CFG.replace("type: res50", "type: mobilenet"))
    (code / "mini_fusion.yml").write_text(PORT_FUSION_CFG)
    (code / "run_cfg.yml").write_text(RUN_CFG)
    for name, path in (("CODE", code), ("DATA", data), ("RUNS", runs)):
        monkeypatch.setenv(name, str(path))
    monkeypatch.delenv("TOKENIZER_VOCAB", raising=False)
    run_dir = str(runs / "mobilenet")
    main(["--config", str(code / "run_cfg.yml"), "--device", "cpu", "--run-dir", run_dir,
          "--epochs", "1"])
    rec = [json.loads(line) for line in open(os.path.join(run_dir, "history.jsonl"))][-1]
    assert np.isfinite(rec["train_loss"]) and rec["train_steps"] >= 1
    assert rec["train_nonfinite_skipped"] == 0.0
    assert "map_box_noun_verb_val" in rec
    assert os.listdir(os.path.join(run_dir, "results")) == ["val_epoch0.json"]
    saved = torch.load(os.path.join(run_dir, "checkpoints", "epoch_0000", "state.pt"),
                       map_location="cpu", weights_only=True)["model"]
    assert "backbone.body.13.block.2.fc1.weight" in saved
    assert not any(k.startswith("backbone.body.conv1") for k in saved)
