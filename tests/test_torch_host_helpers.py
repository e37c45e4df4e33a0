"""The port's host helpers against the JAX package's on the CPU: the frame
and feature readers (a JPEG directory, an MP4 and, through an in-memory
stand-in for the ``lmdb`` package both readers import, the LMDB readers),
the clip frame indices, ``StepTimer``, ``utils.profiling.trace`` on the CPU,
the native STA matcher (built here with the host C++ compiler) against
JAX's native and numpy matchers, and the process-pool loader against the
thread pool and JAX's loader. Every comparison is exact: the same bytes,
indices, tp arrays and batches."""

import io
import json
import os
import sys
import types

import numpy as np
import pytest

from tests.test_torch_config_data import _same, data, env  # noqa: F401
from tests.torch_threads import cap_torch_threads  # noqa: F401


def _jpeg(path, rng, hw=(60, 80)):
    from PIL import Image

    Image.fromarray(rng.integers(0, 256, (*hw, 3), dtype=np.uint8)).save(path, quality=85)


def test_jpg_and_mp4_readers_match_jax(tmp_path):
    """Ego4dJpgReader (the default and an explicit video id) and
    Ego4dMp4Reader (seek-read and frame shape) return JAX's arrays."""
    import cv2

    from transfusion_torch.data import readers as T
    from transfusion_tpu.data import readers as J

    rng = np.random.default_rng(0)
    for vid, frame in (("v0", 7), ("v1", 1234567)):
        _jpeg(tmp_path / f"{vid}_{frame:07d}.jpg", rng)
    t, j = T.Ego4dJpgReader(str(tmp_path), "v0"), J.Ego4dJpgReader(str(tmp_path), "v0")
    _same(t.get_frame(7), j.get_frame(7))
    _same(t.get_frame(1234567, "v1"), j.get_frame(1234567, "v1"))

    path = str(tmp_path / "clip.avi")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10.0, (80, 48))
    for _ in range(6):
        writer.write(rng.integers(0, 256, (48, 80, 3), dtype=np.uint8))
    writer.release()
    t, j = T.Ego4dMp4Reader(path), J.Ego4dMp4Reader(path)
    try:
        assert t.get_img_shape() == j.get_img_shape() == (48, 80, 3)
        for f in (4, 0, 5):
            _same(t.get_frame(f), j.get_frame(f))
        with pytest.raises(IOError):
            t.get_frame(50)
    finally:
        t.close()
        j.close()


class _Txn:
    def __init__(self, store):
        self.store = store

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def get(self, key):
        return self.store.get(key)

    def cursor(self):
        store = self.store
        return types.SimpleNamespace(iternext=lambda values=True: iter(sorted(store)))


class _FakeLmdb(types.ModuleType):
    """What the readers call of the ``lmdb`` package, over dicts keyed by path."""

    def __init__(self, stores):
        super().__init__("lmdb")
        self.stores = stores

    def open(self, path, **kw):
        assert kw == {"readonly": True, "lock": False, "readahead": False, "meminit": False}
        store = self.stores[str(path)]
        return types.SimpleNamespace(begin=lambda write=False: _Txn(store))


def test_lmdb_readers_match_jax(tmp_path, monkeypatch):
    """Ego4dLmdbReader, SlowFastFeaturesReader and FlowJpgReader (frame,
    clip, keys, existence; a flow JPEG at another resolution resized) over
    the same stored bytes give JAX's arrays; a missing key raises KeyError
    or gives None as in JAX."""
    import cv2
    from PIL import Image

    from transfusion_torch.data import readers as T
    from transfusion_tpu.data import readers as J

    rng = np.random.default_rng(1)
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (40, 56, 3), dtype=np.uint8)).save(buf, "JPEG")
    flows = {}
    for f in (3, 9):
        ok, enc = cv2.imencode(".jpg", rng.integers(0, 256, (2 * 24, 32), dtype=np.uint8))
        flows[f"v_{f:010d}".encode()] = enc.tobytes()
    stores = {str(tmp_path / "rgb"): {b"v_0000012": buf.getvalue()},
              str(tmp_path / "feat"): {b"v_12": rng.normal(size=6).astype(np.float32).tobytes()},
              str(tmp_path / "v_jpg"): flows}
    monkeypatch.setitem(sys.modules, "lmdb", _FakeLmdb(stores))

    t, j = T.Ego4dLmdbReader(tmp_path / "rgb", "v"), J.Ego4dLmdbReader(tmp_path / "rgb", "v")
    _same(t.get_frame(12), j.get_frame(12))
    with pytest.raises(KeyError):
        t.get_frame(13)
    t, j = T.SlowFastFeaturesReader(tmp_path / "feat", 3), J.SlowFastFeaturesReader(tmp_path / "feat", 3)
    _same(t.get("v_12"), j.get("v_12"))
    assert t.get("v_13") is None and j.get("v_13") is None
    kw = dict(load_shape=(2, 24, 32), img_shape=(12, 20, 2))
    t, j = T.FlowJpgReader(str(tmp_path), "v", **kw), J.FlowJpgReader(str(tmp_path), "v", **kw)
    _same(t.get_frame(3), j.get_frame(3))
    assert t.get_frame(3).shape == (12, 20, 2)
    _same(t.get_clip([9, 3]), j.get_clip([9, 3]))
    assert t.existing_keys() == j.existing_keys() == {"v_0000000003", "v_0000000009"}
    assert t.check_frames_exist([3, 9]) and not t.check_frames_exist([3, 4])
    with pytest.raises(KeyError):
        t.get_frame(4)


@pytest.mark.parametrize("end,num,stride,block,contact", [(100, 8, 5, 2, 90), (3, 6, 2, 3, 1),
                                                          (50, 4, 10, 1, None), (0, 3, 1, 2, 0)])
def test_clip_frame_indices_match_jax(end, num, stride, block, contact):
    from transfusion_torch.data import readers as T
    from transfusion_tpu.data import readers as J

    assert T.get_clip_frame_idxs(end, num, stride) == J.get_clip_frame_idxs(end, num, stride)
    assert (T.get_clip_frame_idxs_block(end, num, stride, block)
            == J.get_clip_frame_idxs_block(end, num, stride, block))
    for leak in (True, False):
        assert (T.slowfast_feature_window(end, contact, num, stride, leak)
                == J.slowfast_feature_window(end, contact, num, stride, leak))


def test_step_timer_matches_jax_and_trace_names_a_region(tmp_path, monkeypatch):
    """StepTimer's report on the same clock readings equals JAX's (exact);
    ``trace`` on the CPU writes a Chrome trace naming an ``annotate``d
    region and yields the profiler."""
    import time

    import torch

    from transfusion_torch.utils import profiling as T
    from transfusion_tpu.utils import profiling as J

    reports = []
    for mod in (T, J):
        ticks = iter(np.cumsum([0.0, 0.0125, 0.5, 0.003, 0.25, 0.0001, 1.75, 0.02]))
        monkeypatch.setattr(time, "perf_counter", lambda: float(next(ticks)))
        timer = mod.StepTimer()
        for name in ("decode", "device", "decode", "device"):
            with timer.stage(name):
                pass
        reports.append(timer.report())
        timer.reset()
        assert timer.report() == {}
    monkeypatch.undo()
    assert reports[0] == reports[1] and set(reports[0]) == {"decode", "device"}

    with T.trace(str(tmp_path / "trace")) as prof:
        with T.annotate("host_region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    path = tmp_path / "trace" / T.TRACE_FILE
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert "host_region" in names
    assert any(e.key == "host_region" for e in prof.key_averages())


def _match_inputs(rng, n, g):
    def boxes(k):
        xy = rng.uniform(0, 80, (k, 2))
        return np.concatenate([xy, xy + rng.uniform(5, 40, (k, 2))], 1).round()

    pred = boxes(n)
    gt = boxes(g)
    m = min(n, g)  # the first m ground-truth boxes a few pixels off predictions
    gt[:m] = pred[:m] + rng.integers(-4, 5, (m, 4))
    scores = rng.choice([0.9, 0.5, 0.5, 0.3, 0.1], n)  # ties, matched in reverse order
    return ({"boxes": pred, "scores": scores, "nouns": rng.integers(0, 3, n),
             "verbs": rng.integers(0, 2, n), "ttcs": rng.uniform(0, 1, n)},
            {"boxes": gt, "nouns": rng.integers(0, 3, g), "verbs": rng.integers(0, 2, g),
             "ttcs": rng.uniform(0, 1, g)})


def test_native_sta_matcher_matches_jax_native_and_numpy():
    """The port's C++ matcher (built into transfusion_torch/_build/) gives
    the tp arrays of JAX's native matcher and of the numpy matcher, exactly,
    and the metric equals JAX's with either matcher; it is not stubbed."""
    from transfusion_torch.metrics import STAMeanAveragePrecision as TMetric
    from transfusion_torch.metrics import native as T
    from transfusion_tpu.metrics import STAMeanAveragePrecision as JMetric
    from transfusion_tpu.metrics import native as J

    assert T.native_available()
    assert os.path.dirname(T._build()) == T.BUILD_DIR
    rng = np.random.default_rng(5)
    class NumpyMatcher(TMetric):
        def _try_native(self, *args):
            return None

    metrics = {"native": TMetric(), "numpy": NumpyMatcher(), "jax": JMetric()}
    hits = 0
    for n, g in ((12, 4), (30, 9), (5, 5), (0, 3), (7, 0)):
        preds, labels = _match_inputs(rng, n, g)
        tp = T.sta_match_native(*(preds[k] for k in ("boxes", "scores", "nouns", "verbs", "ttcs")),
                                *(labels[k] for k in ("boxes", "nouns", "verbs", "ttcs")), 0.5, 0.25)
        numpy_metric = NumpyMatcher(top_k=None)
        numpy_metric.add(preds, labels)
        if J.native_available():
            want = J.sta_match_native(*(preds[k] for k in ("boxes", "scores", "nouns", "verbs", "ttcs")),
                                      *(labels[k] for k in ("boxes", "nouns", "verbs", "ttcs")), 0.5, 0.25)
            np.testing.assert_array_equal(tp, want)
        if g:
            np.testing.assert_array_equal(tp, numpy_metric._tp[0])
            hits += int(tp.sum())
        for m in metrics.values():
            m.add(preds, labels)
    assert hits > 0
    values = {k: np.asarray(m.evaluate()) for k, m in metrics.items()}
    np.testing.assert_array_equal(values["native"], values["numpy"])
    np.testing.assert_array_equal(values["native"], values["jax"])
    with pytest.raises(ValueError, match="scores"):
        T.sta_match_native(np.zeros((2, 4)), np.zeros(3), np.zeros(2), np.zeros(2), np.zeros(2),
                           np.zeros((1, 4)), np.zeros(1), np.zeros(1), np.zeros(1), 0.5, 0.25)


def test_process_pool_loader_matches_threads_and_jax(data, monkeypatch):  # noqa: F811
    """worker_type="process" (also chosen by TRANSFUSION_LOADER_WORKERS)
    gives the thread pool's and the JAX loader's batches bit for bit over two
    training epochs; a batch that fails in a worker raises in the consumer."""
    import dataclasses

    from transfusion_torch.data.loader import DataLoader as TLoader
    from transfusion_torch.data.transforms import AugConfig as TAug
    from transfusion_tpu.data.loader import DataLoader as JLoader
    from transfusion_tpu.data.transforms import AugConfig as JAug

    port, ref = data
    spec = dict(resize_spec=((64, 96), (80, 128)), crop_spec=(0.9, 0.8), flip=True, channel_order="BGR",
                brightness=0.15, contrast=0.1, saturation=0.1, hue=0.05)
    t_ds = dataclasses.replace(port.train_ds, aug=TAug(**spec))
    kw = dict(training=True, seed=3, lang_max_length=16, drop_last=False, num_workers=2)
    monkeypatch.setenv("TRANSFUSION_LOADER_WORKERS", "process")
    loaders = {"process": TLoader(t_ds, 3, tokenizer=port.tokenizer, **kw),
               "thread": TLoader(t_ds, 3, tokenizer=port.tokenizer, worker_type="thread", **kw),
               "jax": JLoader(dataclasses.replace(ref.train_ds, aug=JAug(**spec)), 3,
                              tokenizer=ref.tokenizer, worker_type="thread", **kw)}
    assert loaders["process"].worker_type == "process"
    try:
        for epoch in range(2):
            got = {k: list(v) for k, v in loaders.items()}
            assert len(got["process"]) == 3, epoch
            for name in ("thread", "jax"):
                for i, (a, b) in enumerate(zip(got["process"], got[name])):
                    _same(a, b, f"{name} epoch {epoch} batch {i}")
    finally:
        for loader in loaders.values():
            loader.close()

    broken = dataclasses.replace(t_ds, frames_dir=os.path.join(t_ds.frames_dir, "missing"))
    loader = TLoader(broken, 3, tokenizer=port.tokenizer, worker_type="process", **kw)
    try:
        with pytest.raises(RuntimeError, match="no readable frames"):
            list(loader)
    finally:
        loader.close()
    with pytest.raises(ValueError, match="worker_type"):
        TLoader(t_ds, 3, worker_type="fiber")
