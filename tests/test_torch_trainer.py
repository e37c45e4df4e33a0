"""The port's trainer, checkpoints and CLI on the CPU, port only: a tiny
config end to end through ``python -m transfusion_torch.runner.run_experiment``
(train, validation, export, checkpoint, resume-eval), the trainer without
PyYAML, pandas, Pillow or OpenCV (the card machine's case when it has none
of them), checkpoint save / restore / tolerant merge / head replacement,
and the options that are not ported yet. The run's losses and metrics are
checked for being finite and in range, the resumed state and evaluation for
being equal bit for bit (the same arithmetic on the same host).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.fixtures import make_synthetic_ego4d
from tests.test_runner_cli import FUSION_CFG, MODEL_CFG, RUN_CFG

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The mini fusion YAML with patches that fit the 64x80 bucket's stride-16
# and -32 maps (4x5 and 2x3): the fusion YAML's (4, 4) would patch the 2x3
# map with a 4x4 kernel. The run YAML is the JAX CLI's, LM head on.
PORT_FUSION_CFG = FUSION_CFG.replace("patch_h: [4, 4, 2, 1]", "patch_h: [2, 1]").replace(
    "patch_w: [4, 4, 2, 1]", "patch_w: [2, 1]")


def _tiny_model():
    from transfusion_torch.models.detector import DetectorConfig
    from transfusion_torch.models.roi_heads import RoIConfig
    from transfusion_torch.models.text_encoder import BertConfig
    from transfusion_torch.models.transfusion import FusionConfig, TransFusion, TransFusionConfig
    from transfusion_torch.weights import init_random_

    cfg = TransFusionConfig(
        detector=DetectorConfig(roi=RoIConfig(num_nouns=7, num_verbs=5, representation_size=32),
                                stage_sizes=(1, 1, 1, 1)),
        fusion=FusionConfig(fpn_features=(3,), patch_h=(1,), patch_w=(1,), num_layers=(1,),
                            token_dim=32, num_heads=2),
        bert=BertConfig(vocab_size=64, hidden_size=16, num_layers=1, num_heads=2,
                        intermediate_size=32, max_position_embeddings=16),
        out_mlp=32)
    return init_random_(TransFusion(cfg, device="cpu"), seed=3)


def test_checkpoint_round_trip(tmp_path):
    """save writes epoch_NNNN/state.pt, its metrics and the latest pointer;
    restore by path, by epoch or from latest loads the parameters and the
    optimizer state bit for bit and returns the step and seed."""
    from transfusion_torch.train.checkpoint import CheckpointManager
    from transfusion_torch.train.optim import make_optimizer
    from transfusion_torch.train.step import TrainState

    model = _tiny_model()
    tx, _ = make_optimizer({"name": "radam"}, None, 1)
    params = dict(model.named_parameters())
    opt = tx.init(params)
    gen = torch.Generator().manual_seed(0)
    for moments in (opt["mu"], opt["nu"]):
        for k, v in moments.items():
            v.copy_(torch.randn(v.shape, generator=gen))
    opt["count"] = 7
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.latest_epoch() is None
    for epoch in (0, 1):
        path = mgr.save(epoch, model, TrainState(step=12 + epoch, opt_state=opt, seed=5),
                        metrics={"map_box_noun_val": 1.5, "epoch": epoch})
    assert path == mgr.epoch_path(1) and os.path.isfile(os.path.join(path, "state.pt"))
    assert open(os.path.join(mgr.dir, "latest")).read() == "epoch_0001"
    assert eval(open(path + ".metrics").read()) == {"map_box_noun_val": 1.5, "epoch": 1.0}
    want = {k: v.clone() for k, v in model.state_dict().items()}
    fresh = _tiny_model()
    for how in ({"path": path}, {"epoch": 1}, {}):
        with torch.no_grad():
            for p in fresh.parameters():
                p.add_(1.0)
        state = mgr.restore(fresh, **how)
        assert (state.step, state.seed, state.opt_state["count"]) == (13, 5, 7)
        for k, v in fresh.state_dict().items():
            assert torch.equal(v, want[k]), k
        for m in ("mu", "nu"):
            for k, v in state.opt_state[m].items():
                assert torch.equal(v, opt[m][k]), (m, k)
    assert mgr.restore(fresh, epoch=0).step == 12
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(fresh)


def test_tolerant_merge_and_replace_heads():
    """tolerant_merge keeps the template where the checkpoint lacks a name
    or its shape drifted and drops names the template lacks; replace_heads
    takes the fresh noun/verb classifiers and box regressor and keeps the
    rest, as the JAX package's (checkpoint.py:103, :137) do."""
    from transfusion_torch.train.checkpoint import HEAD_KEYS, replace_heads, tolerant_merge

    template = dict(_tiny_model().state_dict())
    restored = {k: v + 1.0 if v.is_floating_point() else v for k, v in template.items()}
    drifted = "roi_heads.noun_classifier.weight"
    restored[drifted] = torch.zeros(3, 3)
    missing = "backbone.fpn.inner_blocks.0.weight"
    del restored[missing]
    restored["extra.weight"] = torch.ones(2)
    merged = tolerant_merge(template, restored)
    assert set(merged) == set(template)
    for k, v in merged.items():
        want = template[k] if k in (drifted, missing) else restored[k]
        assert torch.equal(v, want), k
    fresh = {k: torch.full_like(v, 7) if v.is_floating_point() else v for k, v in template.items()}
    out = replace_heads(merged, fresh)
    heads = [k for k in out if any(h in k for h in HEAD_KEYS)]
    assert len(heads) == 6  # weight and bias of each
    for k, v in out.items():
        assert torch.equal(v, fresh[k] if k in heads else merged[k]), k


@pytest.mark.parametrize("criterion", [
    {"bbox": 1, "noun": 1, "verb": 1, "ttc": 1}, {"bbox": 1, "noun": 1, "verb": 1},
    {"bbox": 1, "noun": 1}, {"noun": 1}])
def test_monitor_metric_name_matches_jax(criterion):
    from transfusion_torch.train.checkpoint import monitor_metric_name as t_name
    from transfusion_tpu.train.checkpoint import monitor_metric_name as j_name

    try:
        want = j_name(criterion)
    except NotImplementedError:
        with pytest.raises(NotImplementedError):
            t_name(criterion)
        return
    assert t_name(criterion) == want


@pytest.fixture
def cli_env(tmp_path, monkeypatch):
    code, data, runs = tmp_path / "code", tmp_path / "data", tmp_path / "runs"
    code.mkdir()
    make_synthetic_ego4d(os.path.join(str(data), "Ego4d", "v1"), n_train=8, n_val=4, n_test=2,
                         fh=216, fw=288)
    (code / "mini_model.yml").write_text(MODEL_CFG)
    (code / "mini_fusion.yml").write_text(PORT_FUSION_CFG)
    (code / "run_cfg.yml").write_text(RUN_CFG)
    for name, path in (("CODE", code), ("DATA", data), ("RUNS", runs)):
        monkeypatch.setenv(name, str(path))
    monkeypatch.delenv("TOKENIZER_VOCAB", raising=False)
    return {"config": str(code / "run_cfg.yml"), "runs": str(runs)}


def _cli(cli_env, capsys, *args):
    """``python -m transfusion_torch.runner.run_experiment`` in this
    process; returns what it printed."""
    from transfusion_torch.runner.run_experiment import main

    capsys.readouterr()
    main(["--config", cli_env["config"], "--device", "cpu", *args])
    return capsys.readouterr().out


def test_cli_train_val_export_resume(cli_env, capsys):
    """The port's CLI on the tiny config, LM head on: one epoch with
    validation, the challenge JSON, a checkpoint (the LM head's weights in
    it) and best.json; then --run-val resumed from the checkpoint exports
    the same results and the same metrics."""
    run_dir = os.path.join(cli_env["runs"], "itest")
    _cli(cli_env, capsys, "--run-dir", run_dir, "--epochs", "1")
    history = [json.loads(line) for line in open(os.path.join(run_dir, "history.jsonl"))]
    assert len(history) == 1
    rec = history[0]
    assert np.isfinite(rec["train_loss"]) and rec["train_steps"] == 2
    assert rec["train_nonfinite_skipped"] == 0.0
    assert rec["train_lm_loss"] > 0.0 and rec["val_lm_loss"] > 0.0
    assert "map_box_noun_verb_val" in rec and 0.0 <= rec["map_box_noun_verb_val"] <= 100.0
    assert all(np.isfinite(v) for k, v in rec.items() if k.startswith("val_"))
    files = os.listdir(os.path.join(run_dir, "results"))
    assert files == ["val_epoch0.json"]
    payload = json.load(open(os.path.join(run_dir, "results", files[0])))
    assert payload["challenge"].startswith("ego4d_short_term")
    assert len(payload["results"]) == 4
    for entries in payload["results"].values():
        for e in entries:
            assert set(e) == {"box", "noun_category_id", "verb_category_id", "time_to_contact", "score"}
    ckpt = os.path.join(run_dir, "checkpoints", "epoch_0000")
    assert os.path.isdir(ckpt)
    saved = torch.load(os.path.join(ckpt, "state.pt"), map_location="cpu", weights_only=True)["model"]
    assert {"lm_layer.ln.weight", "lm_layer.mlp_noun.weight", "lm_layer.mlp_verb.weight"} <= set(saved)
    best = json.load(open(os.path.join(run_dir, "checkpoints", "best.json")))
    assert best["metric"] == "map_box_noun_verb_ttc_val" and best["path"] == ckpt

    out = _cli(cli_env, capsys, "--run-dir", run_dir + "_eval", "--run-val", "--resume-from", ckpt)
    metrics = json.loads(out[out.index("{"):])
    for k, v in metrics.items():
        assert v == rec[k] or (v != v and rec[k] != rec[k]), k
    again = json.load(open(os.path.join(run_dir + "_eval", "results", "val_epoch0.json")))
    assert again["results"] == payload["results"]


BLOCKED = """
import sys
for name in ("yaml", "pandas", "PIL", "cv2"):
    sys.modules[name] = None  # import raises ImportError
import numpy as np
import chip_smoke as c
from transfusion_torch.runner.trainer import EgoNaoTrainer

c.B, c.H, c.W, c.TRAINER_TRAIN, c.TRAINER_VAL, c.TRAINER_LANG = 2, 32, 64, 2, 2, 16
cfg = c.flagship_run_config()
cfg["model"].update(stage_sizes=[1, 1, 1, 1], representation_size=32)
cfg["model"]["rcnn_kwargs"]["box_batch_size_per_image"] = 16
run = cfg["run"]
run.update(precision=32, train_bs=2, val_bs=2)
run["narration_embeds"]["args"].update(model_v="minilm-tiny", out_mlp=32)
run["narr_fusion"].update(fpn_features=[3], patch_h=[1], patch_w=[1])
run["narr_fusion"]["args"].update(input_f_size=32, num_layers=[1], num_heads=2)
history = EgoNaoTrainer(cfg, sys.argv[1], device="cpu", data=c.trainer_data(np)).fit(1)
assert history[0]["train_steps"] == 1 and np.isfinite(history[0]["train_loss"])
assert all(sys.modules[n] is None for n in ("yaml", "pandas", "PIL", "cv2"))
print("fit without the file packages:", history[0]["val_loss"])
"""


def test_trainer_runs_without_the_file_packages(tmp_path):
    """With PyYAML, pandas, Pillow and OpenCV unimportable, the trainer
    module imports and fits one epoch (a train step, a validation batch,
    export, checkpoint) on an in-memory TrainerData at 32x64: only the file
    path needs them."""
    proc = subprocess.run([sys.executable, "-c", BLOCKED, str(tmp_path / "run")], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO), capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    assert "fit without the file packages" in proc.stdout
    assert os.path.isfile(tmp_path / "run" / "results" / "val_epoch0.json")
    assert os.path.isfile(tmp_path / "run" / "checkpoints" / "epoch_0000" / "state.pt")


@pytest.mark.parametrize("flag", [["--mesh-model", "2"], ["--mesh-fsdp"], ["--distributed"],
                                  ["--devices", "1"], ["--wandb-entity", "x"],
                                  ["--resume-from", "someuser/proj/run:v3"]])
def test_cli_refuses_unported_flags(flag):
    from transfusion_torch.runner.run_experiment import main

    with pytest.raises(NotImplementedError):
        main(["--config", "unused.yml", "--device", "cpu", *flag])


def test_trainer_refuses_multi_device_arguments(tmp_path):
    from transfusion_torch.runner.trainer import EgoNaoTrainer

    sys.path.insert(0, REPO)
    import chip_smoke

    cfg = chip_smoke.flagship_run_config()
    for kw in ({"mesh": object()}, {"fsdp": True}, {"tp_min_dim": 64}):
        with pytest.raises(NotImplementedError, match=next(iter(kw))):
            EgoNaoTrainer(cfg, str(tmp_path), device="cpu", **kw)
