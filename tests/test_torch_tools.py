"""The port's offline tools (``transfusion_torch/tools/``) against the JAX
package's on the CPU, on the same inputs: each tool's output files and
printed results equal JAX's exactly (the STA evaluator, the JSON
post-processor, the TTC adapter, the detections extractor, the norm
statistics, the frame extractor and the split generator); and the port's
``translate_checkpoint``: a reference-format checkpoint (wrapper prefixes,
a plain stem) into a port checkpoint directory that ``model.pretrained``
loads tensor for tensor, with JAX's provenance sidecar."""

import copy
import json
import os

import numpy as np
import pandas as pd
import pytest
import torch

from tests.fixtures import make_synthetic_ego4d
from tests.test_torch_trainer import cli_env  # noqa: F401
from tests.torch_threads import cap_torch_threads  # noqa: F401


@pytest.fixture(scope="module")
def sta_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sta") / "v1")
    make_synthetic_ego4d(root, n_videos=4, n_train=20, n_val=6, n_test=2, fh=216, fw=288)
    return root


def _results(root, seed=0):
    """Predictions for every val uid: a GT box jittered, and noise."""
    rng = np.random.default_rng(seed)
    with open(os.path.join(root, "annotations", "fho_sta_val.json")) as f:
        anns = json.load(f)["annotations"]
    out = {}
    for a in anns:
        entries = []
        for obj in a["objects"]:
            entries.append({"box": [float(v + rng.integers(-3, 4)) for v in obj["box"]],
                            "noun_category_id": obj["noun_category_id"],
                            "verb_category_id": int(rng.integers(0, 70)),
                            "time_to_contact": float(rng.uniform(0.1, 2)), "score": float(rng.uniform())})
        for _ in range(3):
            x, y = rng.uniform(0, 200, 2)
            entries.append({"box": [float(x), float(y), float(x + 60), float(y + 50)],
                            "noun_category_id": int(rng.integers(0, 6)),
                            "verb_category_id": int(rng.integers(0, 70)),
                            "time_to_contact": float(rng.uniform(0, 2)), "score": float(rng.uniform())})
        out[a["uid"]] = entries
    return out


def _both(name):
    import importlib

    return (importlib.import_module(f"transfusion_torch.tools.{name}"),
            importlib.import_module(f"transfusion_tpu.tools.{name}"))


def _run_main(mod, argv, capsys):
    capsys.readouterr()
    mod.main(argv)
    return capsys.readouterr().out


def test_evaluate_result_json_matches_jax(sta_root, tmp_path, capsys):
    """Sharded prediction JSONs fused and scored: the port's printed STA
    mAP (its STAMeanAveragePrecision) equals JAX's, and evaluate_results
    with a uid left out too."""
    T, J = _both("evaluate_result_json")
    results = _results(sta_root)
    uids = sorted(results)
    for i, part in enumerate((uids[:3], uids[3:])):
        with open(tmp_path / f"shard{i}.json", "w") as f:
            json.dump({"results": {u: results[u] for u in part}}, f)
    argv = [str(tmp_path / "shard0.json"), str(tmp_path / "shard1.json"), "--annotation-dir",
            os.path.join(sta_root, "annotations")]
    got, want = _run_main(T, argv, capsys), _run_main(J, argv, capsys)
    assert got == want and json.loads(got)["ap_box"] > 0
    gt = T.load_gt(os.path.join(sta_root, "annotations", "fho_sta_val.json"))
    partial = {u: results[u] for u in uids[1:]}
    assert T.evaluate_results(partial, gt) == J.evaluate_results(partial, J.load_gt(
        os.path.join(sta_root, "annotations", "fho_sta_val.json")))


def test_json_post_tools_match_jax(sta_root, tmp_path, capsys):
    """postprocess_result_json, adapt_ttc_values and produce_object_detections
    write JAX's files from the same inputs."""
    results = _results(sta_root, seed=1)
    src = tmp_path / "pred.json"
    src.write_text(json.dumps({"version": "1.0", "challenge": "x", "results": results}))
    ref = tmp_path / "ttc_ref.json"
    rng = np.random.default_rng(2)
    ref.write_text(json.dumps({"results": {u: [{"score": e["score"], "time_to_contact": (
        [] if rng.uniform() < 0.3 else float(rng.uniform(0, 2)))} for e in reversed(v)]
        for u, v in results.items()}}))
    cases = (("postprocess_result_json", ["--json-path", str(src), "--annotation-dir",
                                         os.path.join(sta_root, "annotations")], "--output-path"),
             ("adapt_ttc_values", ["--input-path", str(src), "--ttc-reference-path", str(ref)],
              "--output-path"),
             ("produce_object_detections", ["--input-path", str(src)], "--output-path"))
    for name, argv, out_flag in cases:
        T, J = _both(name)
        outs = [tmp_path / f"{name}_{who}.json" for who in ("port", "jax")]
        for mod, out in zip((T, J), outs):
            _run_main(mod, [*argv, out_flag, str(out)], capsys)
        assert outs[0].read_bytes() == outs[1].read_bytes(), name
    T, J = _both("postprocess_result_json")
    with open(os.path.join(sta_root, "annotations", "fho_sta_train.json")) as f:
        train = json.load(f)
    assert T.noun_verb_freqs_from_annotations(train) == J.noun_verb_freqs_from_annotations(train)


def test_frame_tools_match_jax(sta_root, tmp_path, capsys):
    """compute_norm_stats (the frame directory's channel statistics) and
    extract_frames (its frame indices from the annotations, and one
    video's frames decoded in a monotonic pass: the same JPEG bytes)."""
    import cv2

    T, J = _both("compute_norm_stats")
    frames = os.path.join(sta_root, "object_frames")
    for limit in (None, 5):
        for got, want in zip(T.compute_stats(frames, limit), J.compute_stats(frames, limit)):
            np.testing.assert_array_equal(got, want)
    argv = ["--frames-dir", frames, "--limit", "7"]
    assert _run_main(T, argv, capsys) == _run_main(J, argv, capsys)

    T, J = _both("extract_frames")
    ann = os.path.join(sta_root, "annotations")
    assert T.collect_frame_indices(ann) == J.collect_frame_indices(ann)
    path = str(tmp_path / "vid-0000.avi")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 30, (64, 48))
    rng = np.random.default_rng(0)
    for _ in range(30):
        writer.write(rng.integers(0, 255, (48, 64, 3), dtype=np.uint8))
    writer.release()
    for who, mod in (("port", T), ("jax", J)):
        os.makedirs(tmp_path / who)
        assert mod.extract_video(path, [3, 7, 20, 29], str(tmp_path / who)) == 4
        assert mod.extract_video(path, [3, 7], str(tmp_path / who)) == 0  # present: skipped
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) and len(names) == 4
    for n in names:
        assert (tmp_path / "port" / n).read_bytes() == (tmp_path / "jax" / n).read_bytes(), n


def test_generate_splits_matches_jax(sta_root, tmp_path, capsys):
    """generate_split in both split types, and the CLI's CSV, as JAX's."""
    from transfusion_torch.data.annotations import load_sta_annotations

    T, J = _both("generate_splits")
    annots = load_sta_annotations(sta_root)
    for kind in ("group_stratified", "group_shuffle"):
        pd.testing.assert_frame_equal(T.generate_split(annots, kind, "noun", n_subsets=2, seed=1),
                                      J.generate_split(annots, kind, "noun", n_subsets=2, seed=1))
    for who, mod in (("port", T), ("jax", J)):
        _run_main(mod, ["--data-root", sta_root, "--out-dir", str(tmp_path / who), "--seed", "3"], capsys)
    name = "snao_group_stratified_1_3_noun.csv"
    assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


def _reference_checkpoint(model):
    """The model's state dict under the reference's wrapper names
    (rcnn_factory.py:86-92) with its stem plain, plus a key no target takes."""
    sd = {}
    for k, v in model.state_dict().items():
        if k.startswith("rpn."):
            k = k.replace("rpn.", "rpn.rpn_wrap.", 1)
        elif k.startswith("roi_heads."):
            k = k.replace("roi_heads.", "roi_heads.roi_head_wrap.", 1)
        sd[f"model.rcnn_model.rcnn_to_wrap.{k}"] = v.clone()
    sd["model.extra_head.weight"] = torch.zeros(3)
    return {"state_dict": sd, "epoch": 4}


@pytest.mark.parametrize("s2d", [False, True], ids=["plain_stem", "s2d_stem"])
def test_translate_checkpoint_round_trip(cli_env, tmp_path, capsys, s2d):  # noqa: F811
    """A reference .ckpt -> ``<out>/state.pt`` + ``<out>.provenance.json``
    (JAX's sidecar keys and values); every tensor of the source model lands
    under its port name (the stem folded into an s2d model's as
    weights.fold_plain_stem folds it), the stray key is reported; a trainer
    with model.pretrained: <out> loads those tensors, and refuses them under
    the hash tokenizer."""
    import yaml

    from transfusion_torch.config import derive_config, load_config
    from transfusion_torch.models.transfusion import TransFusion, build_transfusion_config
    from transfusion_torch.tools.translate_checkpoint import main
    from transfusion_torch.weights import fold_plain_stem, init_random_, strip_wrapper_prefixes
    from transfusion_tpu.tools.translate_checkpoint import strip_wrapper_prefixes as j_strip

    config = cli_env["config"]
    src_cfg = build_transfusion_config(derive_config(load_config(config)), 7, 71)
    source = init_random_(TransFusion(src_cfg, device="cpu"), seed=9)
    ckpt = _reference_checkpoint(source)
    assert strip_wrapper_prefixes(ckpt["state_dict"]).keys() == j_strip(ckpt["state_dict"]).keys()
    torch.save(ckpt, tmp_path / "ref.ckpt")
    if s2d:
        model_yml = os.path.join(os.environ["CODE"], "mini_model.yml")
        with open(model_yml) as f:
            model = yaml.safe_load(f)
        model["s2d_stem"] = True
        with open(tmp_path / "s2d_model.yml", "w") as f:
            yaml.safe_dump(model, f)
        with open(config) as f:
            run = f.read().replace("${CODE}/mini_model.yml", str(tmp_path / "s2d_model.yml"))
        config = str(tmp_path / "run_s2d.yml")
        with open(config, "w") as f:
            f.write(run)
    out = tmp_path / "translated"
    capsys.readouterr()
    summary = main(["--checkpoint", str(tmp_path / "ref.ckpt"), "--config", config, "--num-nouns", "7",
                    "--num-verbs", "71", "--out", str(out)])
    assert json.loads(capsys.readouterr().out.split("unmatched (first")[0]) == summary
    assert summary["unmatched_source"] == 1 and summary["shape_mismatch"] == []
    assert summary["missing_target"] == 0
    prov = json.loads((tmp_path / "translated.provenance.json").read_text())
    assert prov == {"source": "torch_translation", "pretrained_language_tower": True,
                    "checkpoint": "ref.ckpt"}
    saved = torch.load(out / "state.pt", map_location="cpu", weights_only=True)["model"]
    want = source.state_dict()
    if s2d:
        want = fold_plain_stem(want)
    assert set(saved) == set(want)
    assert all(torch.equal(saved[k], want[k]) for k in want)

    from tests.torch_parallel_workers import _tp_trainer

    cfg = copy.deepcopy(derive_config(load_config(config)))
    cfg["model"]["pretrained"] = str(out)
    trainer = _tp_trainer(cfg, str(tmp_path / "run"), device="cpu")
    with pytest.raises(RuntimeError, match="hash fallback"):
        trainer.ensure_state()
    os.remove(tmp_path / "translated.provenance.json")
    trainer.state = None
    trainer.ensure_state()
    got = trainer.model.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want if got[k].shape == want[k].shape)
