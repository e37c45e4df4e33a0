"""The last host and op functions of the JAX package held against their
port on the same numpy inputs, and the name-by-name scan that pins the port's
coverage of the JAX package.

- ``MergedNaoDataset`` over two sources of the synthetic Ego4D fixture: its
  length, mappings, ``source`` tags and class counts equal, and
  ``get_example`` on each side of the source boundary bit for bit.
- ``pooled_video_narration_lookup``, mean and max: equal vectors.
- ``nms`` (one image): the same kept indices and validity.
- single-level ``roi_align`` in f32 against JAX's XLA path at rtol 1e-5 /
  atol 1e-6 (the port's CPU path is the plain version of K5: another
  order of the same f32 sums), ``sampling_ratio`` 0 and 2;
  ``max_adaptive_samples`` equal.
- the ``ops`` exports and ``BertConfig.minilm_l6`` equal.
- every public top-level function, class, constant and class member
  (method, dataclass or NamedTuple field) of each JAX module has a
  counterpart in the port's module of the same path, read with ``ast``
  (nothing is imported); ALLOWED names each exception and its reason.
"""

import ast
import dataclasses
import os

import numpy as np
import pytest
import torch

from tests.fixtures import make_synthetic_ego4d
from tests.torch_threads import cap_torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    """The fixture's annotations split into two sources, and its frames."""
    from transfusion_tpu.data.annotations import load_sta_annotations
    from transfusion_tpu.data.splits import apply_split, load_split

    fx = make_synthetic_ego4d(tmp_path_factory.mktemp("ego4d"))
    annots = load_sta_annotations(fx["root"], narr_structure="{external_0}; {external_1}",
                                  narr_external_paths=fx["externals"])
    train_df, val_df, _ = apply_split(annots, load_split(annots, {"subset": 0}))
    return annots, train_df, val_df, fx["frames_dir"]


def _merged(pkg, sources):
    import importlib

    ds_mod = importlib.import_module(f"{pkg}.data.dataset")
    labels = importlib.import_module(f"{pkg}.data.labels")
    transforms = importlib.import_module(f"{pkg}.data.transforms")
    annots, train_df, val_df, frames = sources
    # Each source starts from its own mappings; the merge rebuilds them over the union.
    mk = lambda df: ds_mod.EgoNaoDataset(  # noqa: E731
        annots=df, frames_dir=frames,
        noun_mapping=labels.generated_label_mapping(df["all_nouns"].explode()),
        verb_mapping=labels.generated_label_mapping(df["all_verbs"].explode(), "verb"),
        aug=transforms.AugConfig(resize_spec=((96, 128),)),
        narration_lookup=ds_mod.build_narration_lookup(annots, "current"), uid_col="video_id")
    return ds_mod.MergedNaoDataset({"srcA": mk(train_df), "srcB": mk(val_df)})


def test_merged_nao_dataset_matches_jax(sources):
    jm, tm = _merged("transfusion_tpu", sources), _merged("transfusion_torch", sources)
    n_a = len(sources[1])
    assert len(tm) == len(jm) == n_a + len(sources[2])
    assert tm.noun_mapping == jm.noun_mapping and tm.verb_mapping == jm.verb_mapping
    assert (tm.num_nouns, tm.num_verbs) == (jm.num_nouns, jm.num_verbs)
    assert tm.annots["source"].equals(jm.annots["source"])
    assert list(tm.annots.index) == list(jm.annots.index)
    assert tm.narration_lookup == jm.narration_lookup
    for idx in (n_a - 1, n_a):  # the last sample of source A, the first of source B
        for training in (False, True):
            want = jm.get_example(idx, np.random.default_rng(idx), (96, 128), training)
            got = tm.get_example(idx, np.random.default_rng(idx), (96, 128), training)
            assert set(got) == set(want)
            for k, v in want.items():
                if isinstance(v, np.ndarray):
                    assert got[k].dtype == v.dtype and np.array_equal(got[k], v), (idx, k)
                else:
                    assert got[k] == v, (idx, k)


@pytest.mark.parametrize("pooling", ["mean", "max"])
def test_pooled_video_narration_lookup_matches_jax(pooling):
    import pandas as pd

    from transfusion_torch.data.dataset import pooled_video_narration_lookup as t_lookup
    from transfusion_tpu.data.dataset import pooled_video_narration_lookup as j_lookup

    rng = np.random.default_rng(3)
    narrs = ["wash pan", "cut onion", "open drawer", "take knife", "put plate"]
    annots = pd.DataFrame({"video_uid": ["v1", "v1", "v2", "v3", "v3", "v3"],
                           "narration": ["wash pan", "cut onion", "open drawer", "take knife",
                                         "put plate", "wash pan"]},
                          index=[f"u{i}" for i in range(6)])
    # "open drawer" has no vector: v2 falls back to zeros.
    embeds = {n: rng.normal(size=5).astype(np.float32) for n in narrs if n != "open drawer"}
    want, got = j_lookup(annots, embeds, pooling), t_lookup(annots, embeds, pooling)
    assert list(got) == list(want)
    for uid in want:
        assert got[uid].dtype == want[uid].dtype and np.array_equal(got[uid], want[uid]), uid


def test_nms_matches_jax():
    import jax.numpy as jnp

    from transfusion_torch.ops.nms import nms as t_nms
    from transfusion_tpu.ops.nms import nms as j_nms

    rng = np.random.default_rng(5)
    xy = rng.uniform(0, 200, (300, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(10, 80, (300, 2))], 1).astype(np.float32)
    scores = rng.uniform(0, 1, 300).astype(np.float32)
    scores[10:20] = scores[0]  # ties keep input order
    valid = rng.uniform(0, 1, 300) > 0.1
    for thresh, keep, block in ((0.5, 100, 256), (0.7, 40, 64)):
        ji, jv = j_nms(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid), thresh, keep, block)
        ti, tv = t_nms(torch.from_numpy(boxes), torch.from_numpy(scores), torch.from_numpy(valid),
                       thresh, keep, block)
        assert np.array_equal(tv.numpy(), np.asarray(jv))
        assert np.array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("sampling_ratio", [0, 2])
def test_single_level_roi_align_matches_jax(sampling_ratio):
    """One level of 50 x 68 x 16 f32 at scale 1/16, RoIs of every size from
    a few pixels to the whole image (adaptive sampling counts 1 to 10 a
    bin), some past the border: rtol 1e-5 / atol 1e-6."""
    import jax.numpy as jnp

    from transfusion_torch.ops.roi_align import max_adaptive_samples as t_max
    from transfusion_torch.ops.roi_align import roi_align as t_roi_align
    from transfusion_tpu.ops.roi_align import max_adaptive_samples as j_max
    from transfusion_tpu.ops.roi_align import roi_align as j_roi_align

    rng = np.random.default_rng(7)
    feat = rng.normal(size=(50, 68, 16)).astype(np.float32)
    xy = rng.uniform(-20, 1000, (40, 2))
    rois = np.concatenate([xy, xy + rng.uniform(2, 1100, (40, 2))], 1).astype(np.float32)
    want = np.asarray(j_roi_align(jnp.asarray(feat), jnp.asarray(rois), 1 / 16, 7, sampling_ratio))
    got = t_roi_align(torch.from_numpy(feat), torch.from_numpy(rois), 1 / 16, 7, sampling_ratio)
    assert got.shape == (40, 7, 7, 16) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    for shapes, out in (([(50, 68)], 7), ([(200, 256), (100, 128)], 7), ([(9, 9)], 14)):
        assert t_max(shapes, out, sampling_ratio) == j_max(shapes, out, sampling_ratio)


def test_ops_exports_match_jax():
    import transfusion_torch.ops as t_ops
    import transfusion_tpu.ops as j_ops

    assert t_ops.__all__ == j_ops.__all__
    for name in j_ops.__all__:
        assert hasattr(t_ops, name), name
    assert (t_ops.BELOW_LOW_THRESHOLD, t_ops.BETWEEN_THRESHOLDS) == (
        j_ops.BELOW_LOW_THRESHOLD, j_ops.BETWEEN_THRESHOLDS)


def test_minilm_l6_matches_jax():
    from transfusion_torch.models.text_encoder import BertConfig as TBert
    from transfusion_tpu.models.text_encoder import BertConfig as JBert

    assert dataclasses.asdict(TBert.minilm_l6()) == dataclasses.asdict(JBert.minilm_l6())
    assert dataclasses.asdict(TBert.minilm_l12()) == dataclasses.asdict(JBert.minilm_l12())


# JAX names with no counterpart of the same name at the same path, and why
# none is needed. Two kinds need no entry: a flax module's attributes (the
# port's modules take them as constructor arguments) and its ``setup`` (the
# port's ``__init__``).
ALLOWED = {
    "ops/attention.py": {"xla_self_attention": "K7's plain version is self_attention_plain"},
    "ops/roi_align_pallas.py": {
        "*": "K5 and K6 are csrc/roi_align.cu and csrc/roi_align_bwd.cu, wrapped in ops/roi_align.py"},
    "parallel/mesh.py": dict.fromkeys(
        ("batch_sharding", "constrain_activation", "opt_state_shardings", "replicated"),
        "jit sharding helpers: the port moves rows and gradients with explicit collectives "
        "(train/step.py, parallel/fsdp.py, parallel/tensor_parallel.py)"),
    "train/checkpoint.py": {"CheckpointManager.wait": "orbax's asynchronous save: the port saves "
                                                      "synchronously, so there is nothing to wait for"},
    "train/optim.py": {"scale_by_label": "an optax transformation: the port's Chain applies the "
                                         "per-group scales of param_group_label itself"},
    "train/step.py": {
        "TrainState.params": "the port's parameters live in the model; TrainState holds the step, "
                             "the optimizer state and the seed",
        "init_state": "the port's state is TrainState(step, tx.init(params)) beside the model"},
    "models/transfusion.py": {"FusionConfig.class_token_only": "JAX sets it from narr_out_mode and "
                                                               "reads it nowhere; the port reads narr_out_mode"},
    "models/fusion.py": {"FusionLevelConfig": "a flax level's config bundle: the port's levels take "
                                              "its fields as constructor arguments"},
    "models/fusion_variants.py": {"AsymmetricConfig": "a flax level's config bundle: the port's "
                                                      "asymmetric level takes its fields as arguments"},
    "models/resnet.py": {"ConvNorm": "a flax conv + norm pair: the port's ResNet holds torchvision's "
                                     "conv and bn modules by their reference names",
                         "FrozenBatchNorm": "FrozenBatchNorm2d, torchvision's name"},
    "models/roi_heads.py": {"RoIPredictors": "the port's predictors() over RoIHeads' own modules, "
                                             "under the reference's names"},
    "models/text_encoder.py": {"BertSelfAttention": "_SelfAttention, huggingface's module names"},
    "models/resnet_nao.py": {"forward_multivar": "NaoHeads' multivar_n branch, shared by ResnetNao "
                                                 "and ScnnNao"},
    "tools/translate_checkpoint.py": dict.fromkeys(
        ("conv_kernel", "linear_kernel", "fc6_kernel", "backproj_kernel",
         "translate_rcnn_keys", "translate_bert_keys", "translate_gpt2_keys", "translate_t5_keys",
         "translate_lm_tower", "translate_fusion_keys", "translate_minilm"),
        "key renamers and layout changes into JAX's tree: the port keeps the reference's names "
        "and layouts"),
}


def _is_flax_module(node: ast.ClassDef) -> bool:
    return any(isinstance(b, ast.Attribute) and b.attr == "Module" and getattr(b.value, "id", "") == "nn"
               for b in node.bases)


def _public(name: str) -> bool:
    return not name.startswith("_")


def _jax_names(path: str) -> set:
    """Public top-level functions, classes and UPPER_CASE constants, and each
    class's public methods and annotated fields (a flax module's fields and
    setup left out)."""
    out = set()
    for node in ast.parse(open(path).read(), path).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)) and _public(node.name):
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                flax = _is_flax_module(node)
                for b in node.body:
                    if isinstance(b, ast.FunctionDef) and _public(b.name) and not (flax and b.name == "setup"):
                        out.add(f"{node.name}.{b.name}")
                    elif isinstance(b, ast.AnnAssign) and _public(b.target.id) and not flax:
                        out.add(f"{node.name}.{b.target.id}")
        elif isinstance(node, ast.Assign):
            out.update(t.id for t in node.targets
                       if isinstance(t, ast.Name) and _public(t.id) and t.id.isupper())
    return out


def _port_names(path: str) -> set:
    """Everything the port's module defines or imports at the top, and each
    class's members (methods, annotated and assigned names)."""
    out = set()
    for node in ast.parse(open(path).read(), path).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                for b in node.body:
                    if isinstance(b, ast.FunctionDef):
                        out.add(f"{node.name}.{b.name}")
                    elif isinstance(b, ast.AnnAssign):
                        out.add(f"{node.name}.{b.target.id}")
                    elif isinstance(b, ast.Assign):
                        out.update(f"{node.name}.{t.id}" for t in b.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.Assign):
            out.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            out.update((a.asname or a.name).split(".")[0] for a in node.names)
    return out


def test_every_jax_name_has_a_port_counterpart():
    jax_root, port_root = os.path.join(REPO, "transfusion_tpu"), os.path.join(REPO, "transfusion_torch")
    missing, used = [], set()
    modules = 0
    for root, _, files in os.walk(jax_root):
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(root, f), jax_root)
            allowed = ALLOWED.get(rel, {})
            port = os.path.join(port_root, rel)
            if not os.path.exists(port):
                if "*" in allowed:
                    used.add((rel, "*"))
                else:
                    missing.append(f"{rel} (no module)")
                continue
            modules += 1
            have = _port_names(port)
            for name in sorted(_jax_names(os.path.join(root, f)) - have):
                owner = name.split(".")[0]  # a class allowed whole covers its members
                if name in allowed or owner in allowed:
                    used.add((rel, name if name in allowed else owner))
                else:
                    missing.append(f"{rel}: {name}")
    assert modules > 50
    assert missing == [], missing
    # The allow-list names only what the scan still finds.
    stale = [(m, n) for m, names in ALLOWED.items() for n in names if (m, n) not in used]
    assert stale == [], stale
