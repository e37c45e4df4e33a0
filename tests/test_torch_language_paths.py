"""The port's language paths and the transformer TTC head in whole models,
and their host side, against the JAX package's, on the CPU.

Whole models (the golden tiny model of tests/test_golden_detections.py
with one change each): the distilgpt2-style tower in tokens mode; a gated
T5 tower in embedding mode with ``out_tanh``; the identity path with 3-D
``language_f`` (and ``language_mask``) and the TTC head, its second pass
included; the identity path with a 2-D ``language_f``; no language at all.
Each takes one JAX param tree (shapes from ``eval_shape``, filled from a
numpy seed with fan-in scaled values) through
``weights.state_dict_from_jax`` and one JAX eval program (compiled at XLA's
lowest backend optimisation level), against the port's ``make_eval_step``.
Tolerances: RoI outputs at rtol 1e-4 / atol 1e-4 of the output's largest
magnitude (at least 1; the filled predictors give logits up to about 4,
where the golden model's 0.01-normal ones give about 0.1), detections at
rtol 1e-4 / atol 1e-3 with integers exact, as tests/test_torch_slice.py.

Host side: ``build_tokenizer`` under each environment of vocab files,
``build_transfusion_config`` and the trainer data for the towers,
the hand history, precomputed and GloVe narration vectors and type
embeddings against JAX's (fields, and loader batches bit for bit), and the
port's ``EgoNaoTrainer`` fitting one epoch with the distilgpt2 hash
tokenizer and the TTC head on zero-filled hands.
"""

import dataclasses
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.fixtures import make_synthetic_ego4d
from tests.test_runner_cli import FUSION_CFG, MODEL_CFG, RUN_CFG
from tests.test_torch_config_data import _derived, _fields_match, _same
from tests.test_torch_fusion_options import D, _batch, _cfg
from tests.torch_threads import cap_torch_threads  # noqa: F401
from transfusion_torch import weights as W

TTC_HEAD = dict(feat_dim=32, ff_dim=48, num_heads=2, num_layers=1, num_steps=2, emb_steps_hand=20,
                emb_steps_object=30, object_feat_dim=64, max_len=64, dropout=0.0)


def _t(x):
    return torch.from_numpy(np.array(x))


def fill(shapes, seed: int):
    """A param tree of ``shapes`` from a numpy seed, at init-like scales:
    kernels normal / sqrt(fan-in), BN variances in [0.5, 1.5], norm scales
    about 1, everything else normal(0, 0.5)."""
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
            v = rng.normal(0, 0.5, s.shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _towers(pkg: str):
    mod = __import__(f"transfusion_{pkg}.models.lm_encoders", fromlist=["x"])
    return (mod.GPT2Config(vocab_size=64, hidden_size=16, num_layers=2, num_heads=2, max_positions=16),
            mod.T5Config(vocab_size=64, hidden_size=16, num_layers=2, num_heads=2, head_dim=8, ff_dim=24,
                         gated_ff=True))


def _family(pkg: str, family: str):
    """The tiny model of ``family`` in package ``pkg``."""
    gpt2, t5 = _towers(pkg)
    top = {"gpt2": dict(text_encoder="gpt2", gpt2=gpt2),
           "t5": dict(text_encoder="t5", t5=t5, narr_out_mode="embedding", out_tanh=True),
           "identity_ttc_hand": dict(text_encoder="identity", max_ttc_boxes=3),
           "identity_2d": dict(text_encoder="identity"),
           "no_language": dict(use_language=False)}[family]
    cfg = _cfg(pkg, {}, **top)
    if family == "identity_ttc_hand":
        head = __import__(f"transfusion_{pkg}.models.ttc_head", fromlist=["x"]).TTCHeadConfig(**TTC_HEAD)
        roi = dataclasses.replace(cfg.detector.roi, ttc_hand=True)
        cfg = dataclasses.replace(cfg, ttc_hand=head, detector=dataclasses.replace(cfg.detector, roi=roi))
    return cfg


def _family_batch(family: str):
    rng = np.random.default_rng(17)
    batch = {k: v for k, v in _batch(64, 64).items() if k != "visual_features"}
    if family.startswith("identity"):
        lang = (2, 5, D) if family == "identity_ttc_hand" else (2, D)
        batch["language_f"] = rng.normal(0, 1, lang).astype(np.float32)
        if family == "identity_ttc_hand":
            mask = np.ones((2, 5), np.int32)
            mask[0, 3:] = 0
            batch["language_mask"] = mask
            s = TTC_HEAD["num_steps"]
            batch["hand_boxes"] = np.sort(rng.uniform(0, 1, (2, 2 * s, 4)), -1).astype(np.float32)
            batch["hand_poses"] = rng.normal(0, 1, (2, 2 * s, 63)).astype(np.float32)
    return batch


@pytest.mark.parametrize("family", ["gpt2", "t5", "identity_ttc_hand", "identity_2d", "no_language"])
def test_whole_model_eval_matches_jax(family):
    """One eval forward and its detections (with the TTC head's second pass
    where the model has the head), port against JAX."""
    from transfusion_torch.models.transfusion import TransFusion as TModel
    from transfusion_torch.train.step import make_eval_step
    from transfusion_tpu.models.detector import detections_from_outputs as j_dets
    from transfusion_tpu.models.transfusion import TransFusion as JModel

    jcfg, tcfg = _family("tpu", family), _family("torch", family)
    batch, hw = _family_batch(family), (64, 64)
    jmodel = JModel(jcfg)
    train_batch = dict(jax.tree.map(jnp.asarray, batch), image_hw=hw, targets={
        "boxes": jnp.asarray([[[8.0, 8.0, 40.0, 44.0]]] * 2), "nouns": jnp.full((2, 1), 2),
        "verbs": jnp.full((2, 1), 1), "ttcs": jnp.full((2, 1), 0.9), "valid": jnp.ones((2, 1), bool)})
    keys = {"params": jax.random.key(0), "sampling": jax.random.key(1), "dropout": jax.random.key(2)}
    # The training forward creates the TTC head's parameters too.
    shapes = jax.eval_shape(lambda k: jmodel.init(k, train_batch, True), keys)["params"]
    params = fill(shapes, 23)

    def eval_step(p, b):
        b = dict(b, image_hw=hw)
        out = jmodel.apply({"params": p}, b, False)
        dets = j_dets(out, jcfg.detector)
        if jcfg.ttc_hand is not None:
            dets = jmodel.apply({"params": p}, dets, out["roi_outputs"], b, hw, method="predict_ttc")
        return out, dets

    compiled = jax.jit(eval_step).lower(params, batch).compile({"xla_backend_optimization_level": 0})
    jout, jdets = jax.device_get(compiled(params, batch))
    port = TModel(tcfg, device="cpu")
    port.load_state_dict(W.state_dict_from_jax(params), strict=True)
    tbatch = {k: _t(v) for k, v in batch.items()}
    tbatch["input_ids"] = tbatch["input_ids"].long()
    tbatch["image_hw"] = hw
    with torch.no_grad():
        out = port(tbatch)
    dets = make_eval_step(port, tcfg.detector)(tbatch)
    np.testing.assert_array_equal(out["proposals"]["valid"].numpy(), np.asarray(jout["proposals"]["valid"]))
    np.testing.assert_allclose(out["proposals"]["boxes"].numpy(), np.asarray(jout["proposals"]["boxes"]),
                               rtol=1e-4, atol=1e-3)
    for key in ("class_logits", "verb_logits", "box_regression", "ttcs", "box_features"):
        want = np.asarray(jout["roi_outputs"][key])
        np.testing.assert_allclose(out["roi_outputs"][key].numpy(), want, rtol=1e-4,
                                   atol=1e-4 * max(float(np.abs(want).max()), 1.0), err_msg=key)
    assert set(dets) == set(jdets)
    for key, want in jdets.items():
        want = np.asarray(want)
        if want.dtype.kind == "f":
            np.testing.assert_allclose(dets[key].numpy(), want, rtol=1e-4, atol=1e-3, err_msg=key)
        else:
            np.testing.assert_array_equal(dets[key].numpy(), want, err_msg=key)
    if family == "identity_ttc_hand":
        valid = dets["valid"][:, :3]
        assert valid.any() and (dets["ttcs"][:, :3][valid] >= 0.251).all()
        assert not hasattr(port.roi_heads, "ttc_pred_layer")
    if family == "no_language":
        assert not any(k.startswith(("narr_pooling_layer", "cross_fusion")) for k in port.state_dict())


@pytest.mark.parametrize("family", ["gpt2", "t5"])
def test_tower_freeze_multipliers_match_jax(family):
    """The towers' unfreeze sets (GPT-2's last block's MLP, T5's last
    block, and out_mlp) and the LR groups, under the port's names, give
    every parameter the multiplier and group JAX's path rules give it."""
    from transfusion_torch.models.transfusion import TransFusion as TModel
    from transfusion_torch.runner.trainer import tower_depth
    from transfusion_torch.runner.trainer import unfreeze_multipliers as t_mult
    from transfusion_torch.train.optim import param_group_label as t_label
    from transfusion_tpu.models.transfusion import TransFusion as JModel
    from transfusion_tpu.runner.trainer import unfreeze_multipliers as j_mult
    from transfusion_tpu.train.optim import param_group_label as j_label

    jcfg, tcfg = _family("tpu", family), _family("torch", family)
    batch = dict(jax.tree.map(jnp.asarray, _family_batch(family)), image_hw=(64, 64))
    shapes = jax.eval_shape(lambda k: JModel(jcfg).init({"params": k}, batch, False),
                            jax.random.key(0))["params"]
    names = [n for n, _ in TModel(tcfg, device="cpu").named_parameters()]
    codes = {"encoder": 1.0, "main": 2.0, "ttc": 3.0}
    want = W.state_dict_from_jax(jax.tree_util.tree_map_with_path(
        lambda path, x: np.full(x.shape, codes[j_label(path)], np.float32), shapes))
    assert all(np.unique(want[n].numpy()).tolist() == [codes[t_label(n)]] for n in names)
    depth = tower_depth(tcfg)
    for epoch, narr_ep in ((0, -1), (1, 0)):
        mcfg = {"train_ep": -1, "trainable_layers": 2}
        tree = j_mult(shapes, epoch, mcfg, narr_ep, 1, depth, -1, text_encoder=family)
        want = W.state_dict_from_jax(jax.tree.map(lambda m, x: np.full(x.shape, m, np.float32), tree, shapes))
        got = t_mult([(n, None) for n in names], epoch, mcfg, narr_ep, 1, depth, -1, text_encoder=family)
        for n in names:
            assert np.unique(want[n].numpy()).tolist() == [got[n]], (epoch, n)
        tower_on = [n for n in names if got[n] and n.startswith("narr_pooling_layer.encoder.")]
        assert bool(tower_on) == (narr_ep == 0), tower_on


def test_narration_type_embeddings_and_tanh_match_jax():
    """The sbert tower with type embeddings (a [B, L, T] mask) and out_tanh,
    in both out modes."""
    from transfusion_torch.models.text_encoder import BertConfig as TBert
    from transfusion_torch.models.text_encoder import NarrationEncoder as TEnc
    from transfusion_tpu.models.text_encoder import BertConfig as JBert
    from transfusion_tpu.models.text_encoder import NarrationEncoder as JEnc

    bert = dict(vocab_size=64, hidden_size=16, num_layers=1, num_heads=2, intermediate_size=32,
                max_position_embeddings=16)
    rng = np.random.default_rng(19)
    ids = rng.integers(0, 64, (2, 8)).astype(np.int32)
    mask = np.ones((2, 8), np.int32)
    mask[1, 5:] = 0
    tmask = rng.uniform(0, 1, (2, 8, 2)) > 0.6
    for out_mode in ("tokens", "embedding"):
        jenc = JEnc(JBert(**bert), out_mode=out_mode, out_mlp=24, out_tanh=True,
                    type_embeddings=("obj", "act"), type_embedding_init_div=4.0)
        params = jax.device_get(jenc.init(jax.random.key(2), ids, mask, type_mask=tmask))["params"]
        assert {"type_obj", "type_act"} <= set(params)
        tenc = TEnc(TBert(**bert), 24, out_dropout=0.1, out_mode=out_mode, out_tanh=True,
                    type_embeddings=("obj", "act"), type_embedding_init_div=4.0)
        state: dict = {}
        W._narr_encoder(params, state)
        tenc.load_state_dict({k.removeprefix("narr_pooling_layer."): _t(v) for k, v in state.items()},
                             strict=True)
        want, _ = jenc.apply({"params": params}, ids, mask, type_mask=tmask)
        with torch.no_grad():
            got, _ = tenc.eval()(_t(ids).long(), _t(mask), type_mask=_t(tmask))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5, err_msg=out_mode)


# ------------------------------------------------------------- host side
@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The CLI test's mini YAMLs over a synthetic dataset, a FrankMocap
    cache covering part of its frames, a precomputed narration pickle and a
    4-d GloVe table."""
    code = tmp_path_factory.mktemp("code")
    data = tmp_path_factory.mktemp("data")
    root = os.path.join(str(data), "Ego4d", "v1")
    make_synthetic_ego4d(root, n_train=8, n_val=4, n_test=2, fh=216, fw=288)
    (code / "mini_model.yml").write_text(MODEL_CFG)
    (code / "mini_fusion.yml").write_text(FUSION_CFG)
    (code / "run_cfg.yml").write_text(RUN_CFG)
    rng = np.random.default_rng(21)

    def record():
        sides = ("left_hand", "right_hand")
        return {"image_width": 288, "image_height": 216,
                "hand_bbox_list": [{s: rng.uniform(5, 100, 4).astype(np.float32) for s in sides}],
                "pred_output_list": [{s: {"pred_joints_img": rng.uniform(0, 200, (21, 3))} for s in sides}]}

    # The train frames are 1000 + 40 k, the val frames 9000 + 40 k: every
    # fifth frame around them but each fifteenth.
    frames = [f for f in list(range(880, 1400, 5)) + list(range(8880, 9200, 5)) if f % 15]
    cache = {f"vid-{v:04d}": {f: record() for f in frames} for v in range(2)}
    with open(code / "hands.pkl", "wb") as fp:
        pickle.dump(cache, fp)
    # The synthetic narrations read "an object near the 3; person acting 45".
    words = ["an", "object", "near", "the", "person", "acting", "knife"]
    (data / "glove.6B.4d.txt").write_text(
        "\n".join(f"{w} " + " ".join(f"{x:.5f}" for x in rng.normal(0, 1, 4)) for w in words) + "\n")
    with pytest.MonkeyPatch.context() as mp:
        for name, path in (("CODE", code), ("DATA", data), ("RUNS", tmp_path_factory.mktemp("runs"))):
            mp.setenv(name, str(path))
        for name in ("TOKENIZER_VOCAB", "TOKENIZER_DIR", "GPT2_VOCAB_JSON", "GPT2_MERGES", "T5_SPM",
                     "NARR_EMBED_CACHE"):
            mp.delenv(name, raising=False)
        yield {"code": str(code), "data": str(data), "mp": mp}


def _run_config(files, **narr_args):
    import transfusion_torch.config as t_config

    cfg = _derived(t_config, os.path.join(files["code"], "run_cfg.yml"))
    cfg["run"]["narration_embeds"]["args"].update(narr_args)
    cfg["run"]["hand_args"] = {"use": True, "path": "$CODE/hands.pkl", "num_steps": 3, "step": 5}
    return cfg


def _build_both(cfg):
    from transfusion_torch.runner.trainer import build_trainer_data
    from transfusion_tpu.runner.trainer import EgoNaoTrainer as JTrainer

    ref = JTrainer.__new__(JTrainer)
    ref.config, ref.run, ref.debug = cfg, cfg["run"], False
    ref._build_data()
    return build_trainer_data(cfg), ref


@pytest.mark.parametrize("case", ["type_embeddings", "precomputed", "glove", "gpt2_tokens"])
def test_trainer_data_batches_match_jax(files, case, tmp_path):
    """Loader batches with hand_boxes / hand_poses (from the cache, zeros
    where it has no frame), type_mask, and language_f from a precomputed
    pickle or the GloVe table, bit for bit against JAX's data and loader;
    the trainer puts each on the device."""
    from transfusion_torch.data.loader import DataLoader as TLoader
    from transfusion_torch.runner.trainer import EgoNaoTrainer
    from transfusion_tpu.data.loader import DataLoader as JLoader

    if case == "type_embeddings":
        cfg = _run_config(files, type_embeddings=["obj"])
    elif case == "precomputed":
        cfg = _run_config(files, text_pooling="slowfast", size=6)
        from transfusion_torch.runner.trainer import build_trainer_data

        probe = build_trainer_data(cfg)
        uids = list(probe.val_ds.annots.index) + list(probe.train_ds.annots.index)
        rng = np.random.default_rng(22)
        path = tmp_path / "narr.pkl"
        with open(path, "wb") as fp:
            pickle.dump({u: rng.normal(0, 1, 6).astype(np.float32) for u in uids[::2]}, fp)
        files["mp"].setenv("NARR_EMBED_CACHE", str(path))
    elif case == "glove":
        cfg = _run_config(files, type="glove", size=4, pooling="mean")
    else:
        cfg = _run_config(files, model_v="distilgpt2", text_pooling="gpt2")
    port, ref = _build_both(cfg)
    files["mp"].delenv("NARR_EMBED_CACHE", raising=False)
    if case == "type_embeddings":
        # Inline type markers, which the synthetic narrations lack.
        marked = {u: t + ", take knife<obj>" for u, t in port.val_ds.narration_lookup.items()}
        port.val_ds = dataclasses.replace(port.val_ds, narration_lookup=marked)
        ref.val_ds = dataclasses.replace(ref.val_ds, narration_lookup=marked)
    assert type(port.tokenizer).__name__ == type(ref.tokenizer).__name__
    assert getattr(port.tokenizer, "type_names", ()) == getattr(ref.tokenizer, "type_names", ())
    kw = dict(training=False, seed=3, lang_max_length=16, drop_last=False)
    got = list(TLoader(port.val_ds, 3, tokenizer=port.tokenizer, **kw))
    want = list(JLoader(ref.val_ds, 3, tokenizer=ref.tokenizer, **kw))
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        _same(a, b)
    first = got[0]
    assert first["hand_boxes"].shape == (3, 6, 4) and first["hand_poses"].shape == (3, 6, 63)
    assert first["hand_boxes"].any()
    extra = {"type_embeddings": "type_mask", "precomputed": "language_f", "glove": "language_f"}.get(case)
    if extra:
        assert extra in first and first[extra].any()
    trainer = EgoNaoTrainer.__new__(EgoNaoTrainer)
    trainer.device = torch.device("cpu")
    on_device = trainer._device_batch(first)
    for k in ("hand_boxes", "hand_poses") + ((extra,) if extra else ()):
        _same(on_device[k].numpy(), first[k])


NARR = ("run", "narration_embeds", "args")
CONFIG_OPTIONS = {
    "distilgpt2": [(NARR + ("model_v",), "distilgpt2"), (NARR + ("text_pooling",), "gpt2")],
    "flan_t5_large_tanh": [(NARR + ("model_v",), "flan-t5-large"), (NARR + ("out_tanh",), True)],
    "t5_small": [(NARR + ("model_v",), "t5-small"), (NARR + ("text_pooling",), "t5-wikihow")],
    "precomputed_sbert": [(NARR + ("pooling",), "sbert")],
    "ttc_hand_head": [(("run", "criterion", "ttc"), 1),
                      (("model", "ttc_hand_head"), {"use": True, "feat_dim": 512, "num_layers": 2,
                                                    "max_ttc_boxes_per_image": 4}),
                      (("run", "hand_args"), {"use": True, "num_steps": 4})],
}


@pytest.mark.parametrize("case", list(CONFIG_OPTIONS))
def test_build_transfusion_config_maps_the_tower_and_head_options(case):
    """The towers' four T5 geometries and GPT-2, the identity path and the
    TTC head map as JAX's build_transfusion_config maps them, and the
    model builds on the CPU at a tiny trunk."""
    import jax.numpy as jnp

    from tests.test_torch_config_data import _flagship_with
    from transfusion_torch.models import transfusion as t_tf
    from transfusion_tpu.models import transfusion as j_tf

    cfg = _flagship_with(*CONFIG_OPTIONS[case])
    for t_dt, j_dt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = t_tf.build_transfusion_config(cfg, 88, 75, dtype=t_dt)
        _fields_match(got, j_tf.build_transfusion_config(cfg, 88, 75, dtype=j_dt))
    assert got.text_encoder == {"distilgpt2": "gpt2", "precomputed_sbert": "identity",
                                "ttc_hand_head": "sbert"}.get(case, "t5")


def test_trainer_fits_gpt2_with_the_ttc_head(files, tmp_path, monkeypatch):
    """EgoNaoTrainer on the tiny config with model_v distilgpt2 (its hash
    tokenizer over the full 50,257-token vocabulary; the tower narrowed to
    2 layers of 32, as the trunk is), the transformer TTC head and no hand
    cache (zero-filled hands): one epoch of two train steps and
    validation, finite losses, a TTC loss from the head; 64 test-time
    proposals an image (``few_test_proposals``)."""
    import functools

    from tests.test_torch_trainer import few_test_proposals

    from transfusion_torch.models import transfusion as t_tf
    from transfusion_torch.models.lm_encoders import GPT2Config
    from transfusion_torch.runner.trainer import EgoNaoTrainer

    monkeypatch.setattr(t_tf, "GPT2Config", functools.partial(GPT2Config, hidden_size=32, num_layers=2,
                                                               num_heads=2))
    few_test_proposals(monkeypatch)

    cfg = _run_config(files, model_v="distilgpt2", text_pooling="gpt2", train_ep=0)
    cfg["run"]["hand_args"] = {"use": True, "path": str(tmp_path / "missing.pkl"), "num_steps": 2}
    cfg["model"]["ttc_hand_head"] = {"use": True, "feat_dim": 32, "ff_dim": 32, "num_heads": 2,
                                     "num_layers": 1}
    cfg["run"]["narr_fusion"].update(patch_h=[2, 1], patch_w=[2, 1])
    cfg["run"]["criterion"]["lm"] = 0
    trainer = EgoNaoTrainer(cfg, str(tmp_path / "run"), device="cpu")
    assert trainer.model_cfg.text_encoder == "gpt2" and trainer.tokenizer.is_hash_fallback
    assert trainer.model_cfg.ttc_hand is not None
    (rec,) = trainer.fit(1)
    assert rec["train_steps"] == 2 and rec["train_nonfinite_skipped"] == 0.0
    assert np.isfinite(rec["train_loss"]) and rec["train_ttc_loss"] > 0.0
    assert all(np.isfinite(v) for k, v in rec.items() if k.startswith("val_"))
    saved = torch.load(os.path.join(trainer.ckpt.epoch_path(0), "state.pt"), map_location="cpu",
                       weights_only=True)["model"]
    assert "ttc_hand_head.ttc_out.weight" in saved
    assert "narr_pooling_layer.encoder.transformer.h.1.mlp.c_fc.weight" in saved


def test_build_tokenizer_reads_the_environment_as_jax_does(tmp_path, monkeypatch):
    """The port's trainer picks the tokenizer JAX's picks, from the same
    environment variables, files or fallbacks, with the same ids."""
    from transfusion_torch.runner.trainer import build_tokenizer as t_build
    from transfusion_tpu.runner.trainer import build_tokenizer as j_build

    from tests.test_tokenizers import SPM_PIECES, _encode_spm_proto, _toy_gpt2_files

    vj, mg = _toy_gpt2_files(tmp_path)
    spm = tmp_path / "spiece.model"
    spm.write_bytes(_encode_spm_proto(SPM_PIECES))
    texts = ["wash the pan", "I'll wash 2 pans"]
    for env in ({}, {"GPT2_VOCAB_JSON": vj, "GPT2_MERGES": mg, "T5_SPM": str(spm)},
                {"TOKENIZER_DIR": str(tmp_path)}):
        for k in ("GPT2_VOCAB_JSON", "GPT2_MERGES", "T5_SPM", "TOKENIZER_DIR", "TOKENIZER_VOCAB"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        for model_v in ("distilgpt2", "flan-t5-large", "t5-small"):
            ours, ref = t_build(model_v, 16), j_build(model_v, 16)
            assert type(ours).__name__ == type(ref).__name__
            assert getattr(ours, "is_hash_fallback", False) == getattr(ref, "is_hash_fallback", False) \
                == (not env)
            for a, b in zip(ours.encode_batch(texts), ref.encode_batch(texts)):
                np.testing.assert_array_equal(a, b)
