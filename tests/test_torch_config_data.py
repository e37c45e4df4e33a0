"""The port's config and data modules against the JAX package's, on the
CPU: the YAML loader and ``derive_config`` on the CLI test's mini YAMLs,
``build_transfusion_config`` field by field (and the flagship run config of
``chip_smoke.py`` against ``flagship_config()``), and on the synthetic Ego4D
fixture the annotations, label mappings, class weights, frequencies, split
membership, narrations and tokens, and the loader's batches over two epochs
with training and eval transforms. Everything here is host-side numpy and
pandas arithmetic run the same way in both packages, so every comparison is
exact (tolerance 0).
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from tests.fixtures import make_synthetic_ego4d
from tests.test_runner_cli import FUSION_CFG, MODEL_CFG, RUN_CFG

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """The CLI test's mini YAMLs and a synthetic dataset under CODE/DATA."""
    code = tmp_path_factory.mktemp("code")
    data = tmp_path_factory.mktemp("data")
    make_synthetic_ego4d(os.path.join(str(data), "Ego4d", "v1"), n_train=8, n_val=4, n_test=2,
                         fh=216, fw=288)
    (code / "mini_model.yml").write_text(MODEL_CFG)
    (code / "mini_fusion.yml").write_text(FUSION_CFG)
    (code / "run_cfg.yml").write_text(RUN_CFG)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CODE", str(code))
        mp.setenv("DATA", str(data))
        mp.setenv("RUNS", str(tmp_path_factory.mktemp("runs")))
        mp.delenv("TOKENIZER_VOCAB", raising=False)
        yield {"code": str(code), "data": str(data)}


def _derived(pkg, path):
    load, derive = pkg.load_config, pkg.derive_config
    cfg = derive(load(path), {"debug": False, "resume_from": ""})
    cfg.pop("date")  # the derivation's wall-clock stamp
    return cfg


def _same(a, b, where="") -> None:
    """Recursive exact equality of configs, frames' cells and batches."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (where, set(a) ^ set(b))
        for k in a:
            _same(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)) and not isinstance(a, str):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, (np.ndarray, torch.Tensor)) or hasattr(a, "__array__"):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, (where, a.shape, b.shape, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b or (a != a and b != b), (where, a, b)


def test_load_and_derive_config_match_jax(env):
    """load_config (interpolation included) and derive_config (the fusion
    and model YAMLs folded in, the derived sizes) give JAX's dicts."""
    import transfusion_torch.config as t_config
    import transfusion_tpu.config as j_config

    path = os.path.join(env["code"], "run_cfg.yml")
    _same(dict(t_config.load_config(path)), dict(j_config.load_config(path)))
    from transfusion_torch.config.loader import expand_env as t_expand
    from transfusion_tpu.config.loader import expand_env as j_expand

    for text in ("${CODE}/x.yml", "$DATA/y", "${UNSET_VAR_X}z", "plain"):
        assert t_expand(text) == j_expand(text)
    _same(dict(_derived(t_config, path)), dict(_derived(j_config, path)))


# Fields of the port's config that JAX's lacks: the clip features' width,
# which JAX's layer reads from the batch and the port's needs at build.
PORT_ONLY_FIELDS = {"clip_features"}


def _fields_match(port, ref, where=""):
    """Every field of the port's config dataclass equals the JAX config's
    field of the same name (dtypes by name)."""
    for f in dataclasses.fields(port):
        if f.name in PORT_ONLY_FIELDS:
            continue
        a, b = getattr(port, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(a):
            _fields_match(a, b, f"{where}.{f.name}")
        elif isinstance(a, torch.dtype):
            assert str(a).split(".")[-1] == np.dtype(b).name, (where, f.name)
        else:
            assert a == b, (f"{where}.{f.name}", a, b)


def _chip_smoke():
    sys.path.insert(0, REPO)
    import chip_smoke

    return chip_smoke


@pytest.mark.parametrize("which", ["mini", "flagship"])
def test_build_transfusion_config_matches_jax(env, which):
    """build_transfusion_config of a derived run config matches JAX's field
    by field, at f32 and at precision 16; chip_smoke.py's flagship run
    config gives flagship_config() (the trainer sets the frozen-prefix cut,
    5 for the flagship at every epoch, per epoch)."""
    import jax.numpy as jnp

    import transfusion_torch.config as t_config
    from transfusion_torch.models import transfusion as t_tf
    from transfusion_torch.runner.trainer import backbone_stop_grad_stages
    from transfusion_tpu.models import transfusion as j_tf

    if which == "mini":
        cfg = _derived(t_config, os.path.join(env["code"], "run_cfg.yml"))
        nn_, nv = 7, 71
    else:
        cfg = _chip_smoke().flagship_run_config()
        nn_, nv = 88, 75
    for t_dt, j_dt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = t_tf.build_transfusion_config(cfg, nn_, nv, dtype=t_dt)
        _fields_match(got, j_tf.build_transfusion_config(cfg, nn_, nv, dtype=j_dt))
    assert got.fusion.use_flash_attention
    if which == "flagship":
        det = dataclasses.replace(got.detector, stop_grad_stages=backbone_stop_grad_stages(
            0, cfg["model"]))
        assert dataclasses.replace(got, detector=det) == t_tf.flagship_config()


def _flagship_with(*changes):
    """chip_smoke.py's flagship run config with (path, value) changes."""
    cfg = _chip_smoke().flagship_run_config()
    for path, value in changes:
        node = cfg
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = value
    return cfg


@pytest.mark.parametrize("option, path, value", [
    pytest.param("model.batch_norm.use", ("model", "batch_norm", "use"), True,
                 id="model.batch_norm.use-path3-True"),
    pytest.param("model.type", ("model", "type"), "mobilenet", id="model.type-path5-mobilenet"),
])
def test_build_transfusion_config_refuses_unported_options(option, path, value):
    """An option outside the port raises NotImplementedError naming it."""
    from transfusion_torch.models.transfusion import build_transfusion_config

    with pytest.raises(NotImplementedError, match=option.replace(".", r"\.")):
        build_transfusion_config(_flagship_with((path, value)), 88, 75)


@pytest.mark.parametrize("option, path, value", [
    ("narration_embeds.args.out_tanh", ("run", "narration_embeds", "args", "out_tanh"), True),
    ("narration_embeds.args.type_embeddings",
     ("run", "narration_embeds", "args", "type_embeddings"), ["obj"]),
    ("narration_embeds.args.model_v", ("run", "narration_embeds", "args", "model_v"), "distilgpt2"),
    ("run.narration_embeds.use", ("run", "narration_embeds", "use"), False),
])
def test_build_transfusion_config_maps_the_language_options_as_jax(option, path, value):
    """The language options the port once refused map as JAX's
    build_transfusion_config maps them, field by field, at f32 and bf16."""
    import jax.numpy as jnp

    from transfusion_torch.models import transfusion as t_tf
    from transfusion_tpu.models import transfusion as j_tf

    cfg = _flagship_with((path, value))
    for t_dt, j_dt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = t_tf.build_transfusion_config(cfg, 88, 75, dtype=t_dt)
        _fields_match(got, j_tf.build_transfusion_config(cfg, 88, 75, dtype=j_dt))
    field, want = {"narration_embeds.args.out_tanh": ("out_tanh", True),
                   "narration_embeds.args.type_embeddings": ("type_embeddings", ("obj",)),
                   "narration_embeds.args.model_v": ("text_encoder", "gpt2"),
                   "run.narration_embeds.use": ("use_language", False)}[option]
    assert getattr(got, field) == want


NF = ("run", "narr_fusion")
FUSION_OPTIONS = {
    "asymmetric": [(NF + ("type",), "asymmetric"), (NF + ("args", "lang_layers"), 1),
                   (NF + ("args", "vis_dropout"), 0.2)],
    "space_time": [(NF + ("type",), "space_time"), (NF + ("args", "activ_f"), "relu")],
    "shared_sum_learned": [(NF + ("share_encoders",), True), (NF + ("forward_language_f",), "sum"),
                           (NF + ("pos_embedding",), "learned")],
    "direct_sin2d_no_replace": [(NF + ("forward_language_f",), "direct"),
                                (NF + ("pos_embedding",), "sin2d"),
                                (NF + ("replace_fpn_features",), False)],
    "zero_no_final_norm": [(NF + ("pos_embedding",), "zero"), (NF + ("args", "final_norm"), None)],
    "lm_cli": [(("run", "criterion", "lm"), 1), (("run", "criterion", "lm_decay"), 0.8),
               (NF + ("lm_args",), {"pooling": {"type": "mean", "ln": True, "repr_size": 0},
                                    "multi": False, "use_lm_f": True})],
    "lm_max_sep": [(("run", "criterion", "lm"), 1),
                   (NF + ("lm_args",), {"pooling": {"type": "max", "ln": False}, "multi": "sep"})],
    "slowfast_embedding": [(("run", "narration_embeds", "slowfast_f_v"), True),
                           (NF + ("narr_out_mode",), "embedding")],
    "res50_f": [(("run", "narration_embeds", "res50_f"), True)],
}


@pytest.mark.parametrize("case", list(FUSION_OPTIONS))
def test_build_transfusion_config_accepts_the_fusion_options(case):
    """Every fusion option and the LM head map as JAX's
    build_transfusion_config maps them, field by field, and the model
    builds on the CPU; the clip features' width follows the flag."""
    import jax.numpy as jnp

    from transfusion_torch.models import transfusion as t_tf
    from transfusion_tpu.models import transfusion as j_tf

    cfg = _flagship_with(*FUSION_OPTIONS[case])
    cfg["model"]["stage_sizes"] = [1, 1, 1, 1]
    cfg["run"]["narration_embeds"]["args"]["model_v"] = "minilm-tiny"
    cfg["run"]["narr_fusion"]["args"].update(input_f_size=32, num_heads=2, num_layers=[1, 1, 1, 1])
    got = t_tf.build_transfusion_config(cfg, 88, 75)
    _fields_match(got, j_tf.build_transfusion_config(cfg, 88, 75, dtype=jnp.float32))
    assert got.visual_feature_dim == (2048 if case == "res50_f" else 2304)
    model = t_tf.TransFusion(got, device="cpu")
    assert hasattr(model, "lm_layer") or hasattr(model, "lm_layers") or not got.lm_on


@pytest.mark.parametrize("changes", [
    [(NF + ("type",), "heatmap")],
    [(("run", "criterion", "ttc"), 1), (("model", "ttc_hand_head", "use"), True)],
    [(NF + ("type",), "asymmetric"), (NF + ("share_encoders",), True)],
    [(NF + ("type",), "space_time"), (("run", "narration_embeds", "slowfast_f_v"), True)],
])
def test_build_transfusion_config_raises_what_jax_raises(changes):
    """An unknown fusion type, a shared stack or clip features on another
    family than cross_transformer, and the transformer TTC head without the
    hand history (run.hand_args.use) raise JAX's ValueError."""
    import jax.numpy as jnp

    from transfusion_torch.models import transfusion as t_tf
    from transfusion_tpu.models import transfusion as j_tf

    cfg = _flagship_with(*changes)
    with pytest.raises(ValueError) as want:
        j_tf.build_transfusion_config(cfg, 88, 75, dtype=jnp.float32)
    with pytest.raises(ValueError) as got:
        t_tf.build_transfusion_config(cfg, 88, 75)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("case", ["both_clip_flags", "lang_deeper_than_vis", "no_lang_layers"])
def test_fusion_options_jax_cannot_run_are_refused_at_build(case):
    """Where JAX fails only when it runs, the port refuses at build: both
    clip flags (JAX's layer takes F from whichever features the batch
    holds), and an asymmetric level with more language than visual layers
    or none (JAX's loop indexes a missing layer)."""
    from transfusion_torch.models import transfusion as t_tf

    changes = {"both_clip_flags": [(("run", "narration_embeds", "slowfast_f_v"), True),
                                   (("run", "narration_embeds", "res50_f"), True)],
               "lang_deeper_than_vis": [(NF + ("type",), "asymmetric"),
                                        (NF + ("args", "lang_layers"), 3)],
               "no_lang_layers": [(NF + ("type",), "asymmetric"), (NF + ("args", "lang_layers"), 0)]}
    cfg = _flagship_with(*changes[case])
    cfg["model"]["stage_sizes"] = [1, 1, 1, 1]
    cfg["run"]["narration_embeds"]["args"]["model_v"] = "minilm-tiny"
    cfg["run"]["narr_fusion"]["args"].update(input_f_size=32, num_heads=2, num_layers=[2, 2, 2, 2])
    with pytest.raises(ValueError, match="one clip-feature source" if case == "both_clip_flags"
                       else "1 <= lang_layers <= vis_layers"):
        t_tf.TransFusion(t_tf.build_transfusion_config(cfg, 88, 75), device="cpu")


def test_flash_head_dim_is_checked_when_the_model_is_built():
    """On CUDA the attention kernels take bf16 head dim 224 and f32 up to
    256: other head dims raise at build (this check runs before any CUDA
    call); the CPU, or flash attention off, takes any."""
    from transfusion_torch.models.transfusion import check_attention_head_dim, flagship_config

    cfg = flagship_config()
    check_attention_head_dim(cfg, "cuda")
    narrow = dataclasses.replace(cfg, fusion=dataclasses.replace(cfg.fusion, num_heads=8))
    with pytest.raises(ValueError, match="head dim 896 / 8 = 112"):
        check_attention_head_dim(narrow, "cuda")
    check_attention_head_dim(narrow, "cpu")
    check_attention_head_dim(dataclasses.replace(
        narrow, fusion=dataclasses.replace(narrow.fusion, use_flash_attention=False)), "cuda")
    check_attention_head_dim(dataclasses.replace(narrow, dtype=torch.float32), "cuda")
    wide = dataclasses.replace(cfg, dtype=torch.float32,
                               fusion=dataclasses.replace(cfg.fusion, num_heads=2))
    with pytest.raises(ValueError, match="448"):
        check_attention_head_dim(wide, "cuda")


@pytest.fixture(scope="module")
def data(env):
    """(port TrainerData, the JAX trainer's _build_data on the same config)."""
    import transfusion_torch.config as t_config
    from transfusion_torch.runner.trainer import build_trainer_data
    from transfusion_tpu.runner.trainer import EgoNaoTrainer as JTrainer

    cfg = _derived(t_config, os.path.join(env["code"], "run_cfg.yml"))
    port = build_trainer_data(cfg)
    ref = JTrainer.__new__(JTrainer)
    ref.config, ref.run, ref.debug = cfg, cfg["run"], False
    ref._build_data()
    return port, ref


def test_trainer_data_matches_jax(data):
    """Annotations (every column), label mappings, class weights with their
    background slots, noun -> verb frequencies, split membership,
    narrations and the augmentation config equal the JAX trainer's."""
    port, ref = data
    assert port.noun_mapping == ref.noun_mapping and port.verb_mapping == ref.verb_mapping
    _same(port.noun_w, np.asarray(ref.noun_w))
    _same(port.verb_w, np.asarray(ref.verb_w))
    _same(port.noun_verb_freqs, np.asarray(ref.noun_verb_freqs))
    assert dataclasses.asdict(port.aug) == dataclasses.asdict(ref.aug)
    for split in ("train_ds", "val_ds", "test_ds"):
        a, b = getattr(port, split), getattr(ref, split)
        assert list(a.annots.index) == list(b.annots.index), split
        assert list(a.annots.columns) == list(b.annots.columns), split
        for col in a.annots.columns:
            _same(list(a.annots[col]), list(b.annots[col]), f"{split}/{col}")
        assert a.narration_lookup == b.narration_lookup
        assert (a.num_nouns, a.num_verbs) == (b.num_nouns, b.num_verbs)
        assert (a.frames_dir, a.uid_col, a.verb_bg) == (b.frames_dir, b.uid_col, b.verb_bg)
    texts = list(port.val_ds.narration_lookup.values())
    _same(port.tokenizer.encode_batch(texts, 24), ref.tokenizer.encode_batch(texts, 24))


def test_narration_lookup_and_wordpiece_match_jax(data, tmp_path):
    """The prev_k narration strategy with prompts, and a WordPiece
    tokenizer over a vocab file (subwords, unknowns, accents, punctuation,
    truncation, type markers), as JAX builds them."""
    from transfusion_torch.data.dataset import build_narration_lookup as t_lookup
    from transfusion_torch.data.tokenizer import WordPieceTokenizer as TWP
    from transfusion_tpu.data.dataset import build_narration_lookup as j_lookup
    from transfusion_tpu.data.tokenizer import WordPieceTokenizer as JWP

    annots = data[0].train_ds.annots
    kw = dict(start_prompt="before: ", end_prompt=".", empty_prompt="nothing", final_concat=" then ")
    for strategy in ("current", "prev_2"):
        assert t_lookup(annots, strategy, **kw) == j_lookup(annots, strategy, **kw)
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "take", "cut", "knife", "on", "##ion",
             "##s", "pan", "the", ",", ".", "cafe", "<", ">", "obj"]
    path = tmp_path / "vocab.txt"
    path.write_text("\n".join(vocab) + "\n")
    texts = ["Take the knife, cut onions.", "café PANS on the pan", "", "zzz unknown words " * 4,
             "take knife<obj> cut onion<obj>"]
    t_tok, j_tok = TWP.from_vocab_file(str(path), max_length=12), JWP.from_vocab_file(str(path),
                                                                                      max_length=12)
    for text in texts:
        assert t_tok.tokenize(text) == j_tok.tokenize(text)
    _same(t_tok.encode_batch(texts), j_tok.encode_batch(texts))
    _same(t_tok.encode_batch_with_types(texts, ("obj",)), j_tok.encode_batch_with_types(texts, ("obj",)))


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_loader_batches_match_jax_bit_for_bit(data, training):
    """The port's DataLoader gives the JAX loader's batches bit for bit over
    two epochs: order, per-batch bucket (two buckets), per-example crop,
    flip, colour jitter (hue through OpenCV) and resize in training, the
    eval bucket and transform otherwise, targets, tokens, uids, sizes."""
    from transfusion_torch.data.loader import DataLoader as TLoader
    from transfusion_torch.data.transforms import AugConfig as TAug
    from transfusion_tpu.data.loader import DataLoader as JLoader
    from transfusion_tpu.data.transforms import AugConfig as JAug

    port, ref = data
    spec = dict(resize_spec=((64, 96), (80, 128)), crop_spec=(0.9, 0.8), flip=True,
                channel_order="BGR", brightness=0.15, contrast=0.1, saturation=0.1, hue=0.05)
    t_ds = dataclasses.replace(port.train_ds, aug=TAug(**spec))
    j_ds = dataclasses.replace(ref.train_ds, aug=JAug(**spec))
    kw = dict(training=training, seed=3, lang_max_length=16, drop_last=False)
    t_loader = TLoader(t_ds, 3, tokenizer=port.tokenizer, **kw)
    j_loader = JLoader(j_ds, 3, tokenizer=ref.tokenizer, **kw)
    buckets = set()
    for epoch in range(2):
        got, want = list(t_loader), list(j_loader)
        assert len(got) == len(want) == 3, epoch
        for i, (a, b) in enumerate(zip(got, want)):
            _same(a, b, f"epoch {epoch} batch {i}")
            buckets.add(tuple(a["image_hw"]))
    t_loader.close()
    j_loader.close()
    assert len(buckets) == (2 if training else 1)


def test_clip_features_reach_the_batch_as_in_jax(data):
    """A dataset with a clip-feature lookup (uids it lacks zero-filled at
    [6, 2304]) gives the JAX loader's eval batches, visual_features
    included, and the trainer puts them on the device with the images."""
    from transfusion_torch.data.loader import DataLoader as TLoader
    from transfusion_torch.runner.trainer import EgoNaoTrainer
    from transfusion_tpu.data.loader import DataLoader as JLoader

    port, ref = data
    uids = list(port.val_ds.annots.index)
    rng = np.random.default_rng(15)
    lookup = {u: rng.normal(0, 1, (6, 2304)).astype(np.float32) for u in uids[::2]}
    t_ds = dataclasses.replace(port.val_ds, visual_features_lookup=lookup)
    j_ds = dataclasses.replace(ref.val_ds, visual_features_lookup=lookup)
    kw = dict(training=False, seed=3, lang_max_length=16, drop_last=False)
    got = list(TLoader(t_ds, 3, tokenizer=port.tokenizer, **kw))
    want = list(JLoader(j_ds, 3, tokenizer=ref.tokenizer, **kw))
    assert len(got) == len(want) and all("visual_features" in b for b in got)
    for a, b in zip(got, want):
        _same(a, b)
    trainer = EgoNaoTrainer.__new__(EgoNaoTrainer)
    trainer.device = torch.device("cpu")
    on_device = trainer._device_batch(got[0])
    _same(on_device["visual_features"].numpy(), got[0]["visual_features"])
