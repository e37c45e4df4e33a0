"""The trainer's offline detector and its wandb side on the CPU:
``EgoNaoTrainer.make_detect_fn`` on the golden tiny model against JAX's
``transform_example`` + ``make_eval_step`` + ``make_detect_fn``'s rescale
(the golden test's rtol 1e-4 / atol 1e-3, integer slots equal; the one JAX
eval program compiled at XLA's lowest backend optimisation level, no JAX
trainer built), ``runner/wandb_resume.py`` against JAX's with stub wandb
modules (the JAX tests' pattern), and ``fit``'s uploads: the record, the
plot, the ``model-<id>`` checkpoint artifact a fresh trainer resumes from
bit for bit, and the ``results-<id>`` JSON."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_golden_detections import _tiny_model
from tests.test_round3_trainer import _FakeWandbDownload, _FakeWandbModule, _FakeWandbRun
from tests.test_torch_slice import FREQS, _port_cfg, golden  # noqa: F401
from tests.torch_parallel_workers import _tp_trainer, tiny_data, tiny_run_config
from tests.torch_threads import cap_torch_threads  # noqa: F401

AUG = dict(resize_spec=((96,), (128,)), crop_spec=(1, 1), flip=False, channel_order="BGR")


class _EmptyNarrations:
    """The golden model's 64-id vocabulary: [CLS] [SEP] and padding to 8."""

    max_length = 8

    def encode_batch(self, texts):
        ids = np.zeros((len(texts), 8), np.int32)
        ids[:, :2] = (2, 3)
        return ids, (ids > 0).astype(np.int32)


def _frames():
    rng = np.random.default_rng(11)
    return [rng.integers(0, 256, hw, dtype=np.uint8) for hw in ((120, 160, 3), (90, 200, 3))]


def _jax_detect(golden, frames, thresh):  # noqa: F811
    """JAX make_detect_fn's body without a JAX trainer."""
    from transfusion_tpu.data.transforms import AugConfig, transform_example
    from transfusion_tpu.train.step import make_eval_step

    aug, bucket = AugConfig(**AUG), (96, 128)
    ims, scales = [], []
    for img in frames:
        im, _ = transform_example(np.random.default_rng(0), img, np.zeros((0, 4), np.float32), aug,
                                  bucket, training=False)
        ims.append(im)
        scales.append((img.shape[1] / bucket[1], img.shape[0] / bucket[0]))
    ids, mask = _EmptyNarrations().encode_batch([""] * len(frames))
    batch = {"image": jnp.asarray(np.stack(ims)), "input_ids": jnp.asarray(ids),
             "attention_mask": jnp.asarray(mask)}
    model, cfg = _tiny_model()
    step = make_eval_step(model, cfg.detector, noun_verb_frequencies=jnp.asarray(FREQS))
    params = golden["params"]["params"]
    dets = jax.device_get(step.lower(params, batch, bucket).compile(
        {"xla_backend_optimization_level": 0})(params, batch))
    out = []
    for i, (sx, sy) in enumerate(scales):
        v = dets["valid"][i] & (dets["scores"][i] >= thresh)
        out.append((dets["nouns"][i][v], dets["scores"][i][v],
                    dets["boxes"][i][v] * np.array([sx, sy, sx, sy], np.float32)))
    return out


def test_make_detect_fn_matches_jax_on_the_golden_model(golden, tmp_path):  # noqa: F811
    """Per frame (two frame sizes, one batch): the classes equal, scores and
    boxes in the frame's own coordinates at rtol 1e-4 / atol 1e-3; a
    threshold keeps the unthresholded detections at or above it; the
    detector's timer holds the host transform and the device stage."""
    from transfusion_torch.data.transforms import AugConfig
    from transfusion_torch.train.step import make_eval_step

    trainer = _tp_trainer(tiny_run_config(), str(tmp_path), device="cpu", data=tiny_data())
    trainer.ensure_state()
    # The golden model, its eval step, bucket and tokenizer in the trainer.
    trainer.model = golden["port"]
    trainer.eval_step = make_eval_step(golden["port"], _port_cfg().detector, noun_verb_frequencies=FREQS)
    trainer.aug, trainer.tokenizer = AugConfig(**AUG), _EmptyNarrations()
    frames = _frames()
    got = trainer.make_detect_fn()(frames)
    want = _jax_detect(golden, frames, -np.inf)
    assert sum(len(n) for n, _, _ in want) > 0
    for (n, s, b), (jn, js, jb) in zip(got, want):
        np.testing.assert_array_equal(n, jn)
        np.testing.assert_allclose(s, js, rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(b, jb, rtol=1e-4, atol=1e-3)
        assert b.dtype == np.float32 and (b[:, 2] <= 200.0 + 1e-3).all()

    thresh = float(np.median(np.concatenate([s for _, s, _ in got])))
    detect = trainer.make_detect_fn(score_thresh=thresh)
    for (n, s, b), (an, as_, ab) in zip(detect(frames), got):
        keep = as_ >= thresh
        np.testing.assert_array_equal(n, an[keep])
        np.testing.assert_array_equal(s, as_[keep])
        np.testing.assert_array_equal(b, ab[keep])
    assert set(detect.timer.report()) == {"transform", "device"}


class _FakeWandbImages(_FakeWandbModule):
    @staticmethod
    def Image(path):
        return ("image", path)


def _resume_stub(tmp_path):
    """A stub wandb whose Api serves one port checkpoint directory."""
    from tests.test_round3_trainer import _FakeApiArtifact

    ckpt = tmp_path / "uploaded"
    ckpt.mkdir()
    (ckpt / "state.pt").write_bytes(b"x")
    calls = []

    class _Api:
        def artifact(self, name):
            calls.append(name)
            return _FakeApiArtifact({"dirs": [str(ckpt)], "files": []})

    return type("_Wandb", (), {"Api": staticmethod(lambda: _Api())}), calls


def test_resolve_resume_matches_jax(tmp_path, monkeypatch):
    """is_wandb_ref as JAX's on local paths, ids, versions and URLs;
    resolve_resume downloads id:vN and a run URL's latest once into
    <run_dir>/checkpoints/wandb_<id>_<v>, names the directory that holds
    state.pt, refuses a run name and passes a local path through; without
    wandb a reference raises JAX's RuntimeError."""
    from transfusion_torch.runner.wandb_resume import is_wandb_ref, resolve_resume
    from transfusion_tpu.runner import wandb_resume as J

    local = tmp_path / "ckpt"
    local.mkdir()
    for ref in (str(local), "runs/egonao/checkpoints/epoch_0001.ckpt", "abc123xy", "abc123xy:v3",
                "https://wandb.ai/ent/proj/runs/abc123xy", "", "someuser/proj/run:v3"):
        assert is_wandb_ref(ref) == J.is_wandb_ref(ref), ref
    fake, calls = _resume_stub(tmp_path)
    out = resolve_resume("abc123xy:v2", str(tmp_path), entity="ent", project="proj", wandb_module=fake)
    assert calls == ["ent/proj/model-abc123xy:v2"]
    assert out == os.path.join(str(tmp_path), "checkpoints", "wandb_abc123xy_v2")
    assert os.path.isfile(os.path.join(out, "state.pt"))
    assert resolve_resume("abc123xy:v2", str(tmp_path), entity="ent", project="proj",
                          wandb_module=fake) == out and len(calls) == 1
    out = resolve_resume("https://wandb.ai/ent/proj/runs/zz9top", str(tmp_path), wandb_module=fake)
    assert calls[-1] == "transfusion-tpu/model-zz9top:latest" and out.endswith("wandb_zz9top_latest")
    with pytest.raises(ValueError):
        resolve_resume("my-run-name", str(tmp_path), wandb_module=fake)
    assert resolve_resume(None, str(tmp_path)) is None
    assert resolve_resume(str(local), str(tmp_path)) == str(local)
    monkeypatch.setitem(sys.modules, "wandb", None)  # not installed
    with pytest.raises(RuntimeError, match="wandb is not installed"):
        resolve_resume("abc123xy", str(tmp_path))


def test_fit_uploads_and_a_resume_from_the_artifact_is_bit_for_bit(tmp_path):
    """fit(wandb_run=...) logs the epoch's record live, the plot, the
    checkpoint as model-<id> and the result JSON as results-<id>; a fresh
    trainer resumed through resolve_resume("<id>:v0") holds the fitted
    parameters, moments, step and seed bit for bit; log_checkpoints=False
    uploads no model artifact."""
    from transfusion_torch.runner.wandb_resume import resolve_resume

    data = tiny_data()
    trainer = _tp_trainer(tiny_run_config(), str(tmp_path / "run"), device="cpu", data=data)
    store = {}
    wb = _FakeWandbRun(store=store)
    history = trainer.fit(epochs=1, wandb_run=wb, wandb_module=_FakeWandbImages, log_checkpoints=True)
    steps = [s for s, _ in wb.logged]
    assert steps == [0, 0] and wb.logged[0][1] == history[0]
    assert wb.logged[1][1] == {"plots/val": ("image", trainer.last_plot_path)}
    assert {(a.name, a.type) for a in wb.artifacts} == {(f"model-{wb.id}", "model"),
                                                         (f"results-{wb.id}", "result")}
    assert store[f"model-{wb.id}:v0"]["dirs"] == [trainer.ckpt.epoch_path(0)]
    assert store[f"results-{wb.id}:v0"]["files"] == [
        os.path.join(str(tmp_path / "run"), "results", "val_epoch0.json")]

    local = resolve_resume(f"{wb.id}:v0", str(tmp_path / "fresh"), entity="e", project="p",
                           wandb_module=_FakeWandbDownload(store))
    fresh = _tp_trainer(tiny_run_config(), str(tmp_path / "fresh"), device="cpu", data=data)
    fresh.ensure_state(resume_from=local)
    want, got = trainer.model.state_dict(), fresh.model.state_dict()
    assert set(want) == set(got) and all(torch.equal(want[k], got[k]) for k in want)
    for m in ("mu", "nu"):
        for k, v in trainer.state.opt_state[m].items():
            assert torch.equal(fresh.state.opt_state[m][k], v), (m, k)
    assert (fresh.state.step, fresh.state.seed) == (trainer.state.step, trainer.state.seed) != (0, None)

    wb = _FakeWandbRun(id="nockpt")
    trainer.fit(epochs=1, wandb_run=wb, wandb_module=_FakeWandbModule, log_checkpoints=False)
    assert [a.type for a in wb.artifacts] == ["result"] and wb.logged


def test_provenance_sidecar_refuses_a_hash_tokenizer(tmp_path):
    """A checkpoint with a translate_checkpoint sidecar (pretrained language
    tower) raises JAX's RuntimeError on resume and as model.pretrained while
    the tokenizer is a hash fallback (tests/test_round3_trainer.py:224)."""
    cfg = tiny_run_config()
    trainer = _tp_trainer(cfg, str(tmp_path / "run"), device="cpu", data=tiny_data())
    assert trainer.tokenizer.is_hash_fallback
    ckpt = tmp_path / "translated_ckpt"
    ckpt.mkdir()
    (tmp_path / "translated_ckpt.provenance.json").write_text(
        '{"source": "torch_translation", "pretrained_language_tower": true}')
    with pytest.raises(RuntimeError, match="hash fallback"):
        trainer.ensure_state(resume_from=str(ckpt))
    trainer.state = None
    cfg["model"]["pretrained"] = str(ckpt)
    with pytest.raises(RuntimeError, match="hash fallback"):
        _tp_trainer(cfg, str(tmp_path / "pre"), device="cpu", data=tiny_data()).ensure_state()
