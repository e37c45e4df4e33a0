"""The legacy heatmap family's losses, targets, data and metrics in the port
against the JAX package's, on the CPU: every ``hmap_criterion`` branch with
each ``pixel_w`` form and aggregation, ``sample_heatmap_coords`` on JAX's
own uniforms (indices exactly, an image with fewer nonzero pixels than
samples included), ``mvn_nll`` and ``multivar_n_loss``, the heatmap
targets, ``SNaoDataset`` + ``snao_collate`` over the Ego4D base, the EPIC
NAO ingest (``filter_nao_annotations`` with and without take_double,
``load_nao_dataset_frame`` on csv and pkl files that the JAX label tool
writes, ``EpicNaoDataset`` under ``SNaoDataset``) and ``hmap_metrics``.

Tolerances: the losses in f32 within 1e-5 relative (sums in another
order); the coordinates' pixel indices exactly and their f32 values within
1e-6; targets, samples, batches, frames and metrics bit for bit (the same
numpy arithmetic).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from tests.torch_threads import cap_torch_threads  # noqa: F401


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(np.asarray(got.detach().float()), np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


# ---------------------------------------------------------------- losses
CRITERIA = ({"mae": 1}, {"smooth_mae": 1}, {"mse": 1}, {"ce": 1}, {"focal": 1}, {"kl_div": 1}, {})


def test_hmap_criterion_matches_jax():
    """Each elementwise loss (mae, smooth_mae, mse, ce, focal, kl_div and
    the mae default) at pixel_w 1, a scalar and "reg", summed or averaged."""
    from transfusion_torch.train.losses import hmap_criterion
    from transfusion_tpu.train.losses import hmap_criterion as j_hmap_criterion

    rng = np.random.default_rng(0)
    preds = rng.normal(0, 1.5, (3, 6, 8)).astype(np.float32)
    targets = np.where(rng.uniform(0, 1, (3, 6, 8)) < 0.6, 0.0, rng.uniform(0, 1, (3, 6, 8))).astype(np.float32)
    logp = np.asarray(jax.nn.log_softmax(jnp.asarray(preds).reshape(3, -1), -1)).reshape(3, 6, 8)
    dist = (targets / targets.reshape(3, -1).sum(-1)[:, None, None]).astype(np.float32)
    fg, bg = np.array([0.3, 0.5, 0.9], np.float32), np.array([0.7, 0.5, 0.1], np.float32)
    n = 0
    for crit in CRITERIA:
        p, t = (logp, dist) if "kl_div" in crit else (preds, targets)
        for pixel_w in (1, 3.0, "reg"):
            for agg in ("mean", "sum"):
                c = {**crit, "agg": agg}
                want = j_hmap_criterion(c, pixel_w)(jnp.asarray(p), jnp.asarray(t), jnp.asarray(fg),
                                                    jnp.asarray(bg))
                got = hmap_criterion(c, pixel_w)(_t(p), _t(t), _t(fg), _t(bg))
                np.testing.assert_allclose(float(got), float(want), rtol=1e-5, err_msg=f"{c} {pixel_w}")
                n += 1
    assert n == 42


def _sparse_heatmaps():
    """Image 0 a gaussian target, image 1 only three nonzero pixels (fewer
    than the 16 samples: the rest tie at -inf)."""
    from transfusion_torch.data.heatmaps import gaussian_heatmap

    hm = np.zeros((2, 12, 16), np.float32)
    hm[0] = gaussian_heatmap(np.array([[3.0, 2.0, 9.0, 8.0]]), 12, 16, normalize=True)
    hm[1, 4, 5], hm[1, 7, 2], hm[1, 10, 15] = 0.5, 0.25, 0.25
    return hm


def test_sample_heatmap_coords_match_jax_exactly():
    """On the uniforms JAX draws, the port picks JAX's pixels in JAX's
    order, the -inf ties by the lower index as lax.top_k takes them; from a
    torch.Generator it picks distinct pixels, every pixel of mass first."""
    from transfusion_torch.data.heatmaps import MAX_STD
    from transfusion_torch.train.losses import sample_heatmap_coords
    from transfusion_tpu.train.losses import sample_heatmap_coords as j_sample

    hm, s = _sparse_heatmaps(), 16
    b, h, w = hm.shape

    def pixels(coords):
        c = np.asarray(coords, np.float64)
        ys = np.rint((c[..., 0] + MAX_STD * h / w) / (2 * MAX_STD * h / w) * h).astype(int)
        xs = np.rint((c[..., 1] + MAX_STD) / (2 * MAX_STD) * w).astype(int)
        return ys * w + xs

    for seed in range(3):
        key = jax.random.key(seed)
        u = np.asarray(jax.random.uniform(key, (b, h * w), minval=1e-12, maxval=1.0))
        want = np.asarray(j_sample(key, jnp.asarray(hm), s))
        got = sample_heatmap_coords(_t(hm), s, uniforms=_t(u))
        np.testing.assert_array_equal(pixels(got), pixels(want))
        _close(got, want, 1e-6)
        assert sorted(pixels(want)[1, :3]) == [4 * w + 5, 7 * w + 2, 10 * w + 15]
        zero_tail = pixels(want)[1, 3:]
        assert list(zero_tail) == [i for i in range(h * w) if hm[1].reshape(-1)[i] == 0][:s - 3]
    drawn = pixels(sample_heatmap_coords(_t(hm), s, generator=torch.Generator().manual_seed(4)))
    assert all(len(set(r)) == s for r in drawn) and set(drawn[1, :3]) == {4 * w + 5, 7 * w + 2, 10 * w + 15}


def test_mvn_nll_and_multivar_loss_match_jax():
    """mvn_nll at random Gaussians and samples, and multivar_n_loss end to
    end on JAX's uniforms for its key."""
    from transfusion_torch.train.losses import multivar_n_loss, mvn_nll
    from transfusion_tpu.train import losses as jl

    rng = np.random.default_rng(1)
    loc = rng.normal(0, 1, (2, 2)).astype(np.float32)
    tril = np.zeros((2, 2, 2), np.float32)
    tril[:, 0, 0], tril[:, 1, 1] = rng.uniform(0.5, 2, 2), rng.uniform(0.5, 2, 2)
    tril[:, 1, 0] = rng.normal(0, 0.5, 2)
    samples = rng.normal(0, 2, (2, 16, 2)).astype(np.float32)
    _close(mvn_nll(_t(loc), _t(tril), _t(samples)), jl.mvn_nll(jnp.asarray(loc), jnp.asarray(tril),
                                                                  jnp.asarray(samples)))
    hm = _sparse_heatmaps()
    key = jax.random.key(9)
    u = np.asarray(jax.random.uniform(key, (2, hm.shape[1] * hm.shape[2]), minval=1e-12, maxval=1.0))
    crit = {"multivar_n": 1, "no_samples": 16}
    want = jl.multivar_n_loss(crit)({"loc": jnp.asarray(loc), "scale_tril": jnp.asarray(tril)},
                                    jnp.asarray(hm), key)
    got = multivar_n_loss(crit)({"loc": _t(loc), "scale_tril": _t(tril)}, _t(hm), uniforms=_t(u))
    _close(got, want)


# ------------------------------------------------------------ targets, data
def test_heatmap_targets_match_jax():
    from transfusion_torch.data.heatmaps import boxes_area, get_img_heatmap
    from transfusion_tpu.data import heatmaps as jh

    boxes = np.array([[10.2, 5.0, 40.7, 30.1], [-3.0, 20.0, 12.0, 47.0]], np.float32)
    for kind in ("const", "gaussian", "gaussian_dist"):
        np.testing.assert_array_equal(get_img_heatmap(kind)(boxes, 48, 64), jh.get_img_heatmap(kind)(boxes, 48, 64))
    assert boxes_area(boxes) == jh.boxes_area(boxes)


@pytest.fixture(scope="module")
def ego4d(tmp_path_factory):
    from tests.fixtures import make_synthetic_ego4d

    return make_synthetic_ego4d(str(tmp_path_factory.mktemp("ego4d")), n_train=6, n_val=2, n_test=1,
                                fh=270, fw=360)


def _ego_base(pkg: str, fx):
    mod = lambda name: __import__(f"transfusion_{pkg}.data.{name}", fromlist=["x"])  # noqa: E731
    annots = mod("annotations").load_sta_annotations(fx["root"], narr_structure="{external_0}",
                                                     narr_external_paths=fx["externals"])
    labels = mod("labels")
    ds = mod("dataset")
    return ds.EgoNaoDataset(
        annots=annots, frames_dir=fx["frames_dir"],
        noun_mapping=labels.generated_label_mapping(annots["all_nouns"].explode()),
        verb_mapping=labels.generated_label_mapping(annots["all_verbs"].explode()),
        aug=mod("transforms").AugConfig(resize_spec=((48, 64),)),
        narration_lookup=ds.build_narration_lookup(annots, "current"), uid_col="video_id")


def _same_batch(got: dict, want: dict):
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            assert got[k] == v, k


@pytest.mark.parametrize("kind", ["const", "gaussian", "gaussian_dist"])
def test_snao_dataset_and_collate_match_jax(ego4d, kind):
    """SNaoDataset over the Ego4D base, training (random crops and flips
    from one seed) and eval, then snao_collate: bit for bit JAX's."""
    from transfusion_torch.data.snao import SNaoDataset, snao_collate
    from transfusion_tpu.data.snao import SNaoDataset as JSNao
    from transfusion_tpu.data.snao import snao_collate as j_collate

    port, ref = SNaoDataset(_ego_base("torch", ego4d), kind), JSNao(_ego_base("tpu", ego4d), kind)
    assert (len(port), port.num_nouns, port.num_verbs) == (len(ref), ref.num_nouns, ref.num_verbs)
    for training in (True, False):
        ga, gb = np.random.default_rng(3), np.random.default_rng(3)
        got = [port.get_example(i, ga, (48, 64), training) for i in range(4)]
        want = [ref.get_example(i, gb, (48, 64), training) for i in range(4)]
        for a, b in zip(got, want):
            _same_batch(a, b)
        _same_batch(snao_collate(got), j_collate(want))


def _nao_tree(root):
    """An EPIC actor directory with two videos' NAO labels written by the JAX
    label tool: P01_01 as csv and pkl (the pkl is read), P01_02 as csv
    only (read through read_detections_csv); three narrations each."""
    from PIL import Image

    from transfusion_tpu.tools import label_extraction as le

    adir = root / "data" / "P01"
    adir.mkdir(parents=True)
    fps, frames = 30.0, list(range(10, 200, 15))
    rows = []
    for v, video in enumerate(("P01_01", "P01_02")):
        for f in frames:
            img = np.full((60, 80, 3), 90 + 20 * v, np.uint8)
            img[20:40, 30:60] = [200, 40, 40]
            Image.fromarray(img).save(adir / f"{video}_{f:07d}.jpg")
        annots = pd.DataFrame([
            {"start_frame": s, "narration_id": f"{video}_{i}", "narration": f"{verb} {noun}",
             "starting_ms": s / fps * 1000, "fps": fps, "verb": verb, "all_nouns": [noun]}
            for i, (s, verb, noun) in enumerate(((60, "take", "cup"), (130, "wash", "pan"),
                                                 (190, "open", "cup")))])
        rows.append(annots)

        def detect(images):
            return [(np.array([0, 1]), np.array([0.9, 0.6]),
                     np.array([[30.0, 20.0, 60.0, 40.0], [5.0, 5.0, 25.0, 30.0]])) for _ in images]

        det = le.extract_detections_for_video(
            detect, lambda f, video=video: np.asarray(Image.open(adir / f"{video}_{f:07d}.jpg")), frames,
            ["cup", "pan"])
        path = le.detections_csv_path(adir, video)
        le.write_detections_csv(det, path)
        soft = {"actions": {}, "no_matches": [], "cup": {"default": ["cup"]}, "pan": {"default": ["pan"]}}
        labels = le.label_video(le.read_detections_csv(path), annots, soft, version=1)
        out = le.nao_csv_path(adir, video, 1)
        labels.to_csv(out)
        if v == 0:
            labels.to_pickle(str(out)[: -len("csv")] + "pkl")
    return pd.concat(rows, ignore_index=True)


@pytest.mark.parametrize("take_double", [False, True])
def test_filter_nao_annotations_matches_jax(take_double):
    """The det_diff filter on clips with several frames each, frames tied
    on det_diff and a clip left empty by the offset."""
    from transfusion_torch.data.epic_nao import filter_nao_annotations
    from transfusion_tpu.data.epic_nao import filter_nao_annotations as j_filter

    rng = np.random.default_rng(2)
    n = 40
    df = pd.DataFrame({
        "Frame_no": rng.permutation(np.arange(10, 10 + 5 * n, 5)),
        "nao_clip_id": rng.choice(["c1", "c2", "c3", "c4"], n),
        "nao_start_sec": 0.0,
        "det_sec": rng.integers(0, 60, n) / 10.0,
    })
    df["nao_start_sec"] = df["nao_clip_id"].map({"c1": 6.0, "c2": 4.0, "c3": 2.5, "c4": 0.1})
    df = df.set_index("Frame_no")
    pd.testing.assert_frame_equal(filter_nao_annotations(df, 0.25, take_double), j_filter(df, 0.25, take_double))


def test_nao_ingest_matches_jax(tmp_path):
    """load_nao_dataset_frame on the label tool's files (csv and pkl, with
    and without take_double) and EpicNaoDataset under SNaoDataset (image,
    heatmap, labels, the det_diff TTC): bit for bit JAX's."""
    from transfusion_torch.data import epic_nao as tp
    from transfusion_torch.data.labels import generated_label_mapping
    from transfusion_torch.data.snao import SNaoDataset, snao_collate
    from transfusion_torch.data.transforms import AugConfig
    from transfusion_tpu.data import epic_nao as jp
    from transfusion_tpu.data import snao as js
    from transfusion_tpu.data.transforms import AugConfig as JAug

    root = tmp_path / "EK"
    annots = _nao_tree(root)
    path = jp.actor_dir(root, "epic", "P01") / "P01_01_nao_1.csv"
    from transfusion_tpu.tools.label_extraction import read_detections_csv as j_read

    pd.testing.assert_frame_equal(tp.read_detections_csv(path), j_read(path))
    for take_double in (False, True):
        kw = dict(annotations=annots, data_root=root, actors=["P01"], offset_s=0.1, version=1,
                  take_double=take_double)
        got, want = tp.load_nao_dataset_frame("epic", **kw), jp.load_nao_dataset_frame("epic", **kw)
        pd.testing.assert_frame_equal(got, want)
        assert len(want) and set(want["video"]) == {"P01_01", "P01_02"}
    nmap, vmap = generated_label_mapping(want["noun"]), generated_label_mapping(want["verb"], "verb")
    aug = dict(resize_spec=((64,), (64,)), crop_spec=(1, 1), flip=False)
    port = SNaoDataset(tp.EpicNaoDataset(annots=got, dataset_name="epic", data_root=root, aug=AugConfig(**aug),
                                         noun_mapping=nmap, verb_mapping=vmap), "gaussian")
    ref = js.SNaoDataset(jp.EpicNaoDataset(annots=want, dataset_name="epic", data_root=root, aug=JAug(**aug),
                                           noun_mapping=nmap, verb_mapping=vmap), "gaussian")
    ga, gb = np.random.default_rng(5), np.random.default_rng(5)
    a = snao_collate([port.get_example(i, ga, (64, 64), True) for i in range(len(port))])
    b = js.snao_collate([ref.get_example(i, gb, (64, 64), True) for i in range(len(ref))])
    _same_batch(a, b)
    assert b["heatmap"].max() > 0 and b["ttc"].min() > 0.1


# ------------------------------------------------------------------ metrics
def test_hmap_metrics_match_jax():
    """MAEWithNorm and HeatmapAccuracy with and without the norm, and
    CoordMetric, streamed over three batches: bit for bit."""
    from transfusion_torch.metrics import hmap_metrics as tm
    from transfusion_tpu.metrics import hmap_metrics as jm

    rng = np.random.default_rng(4)
    pairs = [(rng.uniform(0, 1, (3, 12, 16)), rng.uniform(0, 2, (3, 12, 16))) for _ in range(3)]
    for make in (lambda m: m.MAEWithNorm(True), lambda m: m.MAEWithNorm(False),
                 lambda m: m.HeatmapAccuracy(True), lambda m: m.HeatmapAccuracy(False),
                 lambda m: m.CoordMetric((12, 16))):
        got, want = make(tm), make(jm)
        for p, t in pairs:
            got.update(p, t)
            want.update(p, t)
        assert got.compute() == want.compute()
