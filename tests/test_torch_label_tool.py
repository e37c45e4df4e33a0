"""The port's label-extraction tool (``tools/label_extraction.py``) against
the JAX package's on the CPU, exactly: the box math and row NMS, every
matching case, per-video labeling, the CSV rows and files (read back by
JAX's ``read_detections_csv``), the ``label`` subcommand's files, and the
``extract`` subcommand end to end on a synthetic dataset (``--device cpu``):
its CSV is JAX's ``detections_to_rows`` of the detector's outputs, byte for
byte; without ``--device`` it runs on CUDA or raises, never the CPU."""

import json
import os

import numpy as np
import pandas as pd
import pytest

from tests.test_label_extraction import SOFT, _annots, _detections, det_row
from tests.test_torch_trainer import cli_env, few_test_proposals  # noqa: F401
from tests.torch_threads import cap_torch_threads  # noqa: F401
from transfusion_torch.tools import label_extraction as T
from transfusion_tpu.tools import label_extraction as J


def _boxes(rng, n):
    xy = rng.uniform(0, 50, (n, 2)).astype(np.float32)
    return np.concatenate([xy, xy + rng.uniform(1, 30, (n, 2)).astype(np.float32)], 1)


def test_box_math_and_row_nms_match_jax():
    rng = np.random.default_rng(0)
    a, b, pts = _boxes(rng, 7), _boxes(rng, 5), rng.uniform(0, 60, (4, 2))
    for name in ("pairwise_intersection", "pairwise_iou"):
        np.testing.assert_array_equal(getattr(T, name)(a, b), getattr(J, name)(a, b))
    np.testing.assert_array_equal(T.pairwise_point_box_distance(pts, b),
                                  J.pairwise_point_box_distance(pts, b))
    classes = np.array(["cup", "pan", "cup", "knife", "cup", "pan", "plate"])
    boxes = np.repeat(_boxes(rng, 3), [3, 2, 2], axis=0) + rng.uniform(0, 3, (7, 4)).astype(np.float32)
    scores = rng.uniform(0, 1, 7)
    for iou in (0.0, 0.4, 0.9):
        for got, want in zip(T.nms_row(classes, scores, boxes, iou), J.nms_row(classes, scores, boxes, iou)):
            np.testing.assert_array_equal(got, want)


ROWS = [
    (["cucumber", "knife", "person"], [[0, 0, 10, 10], [20, 20, 30, 30], [8, 8, 25, 25]]),
    (["zucchini", "person", "pepper", "cutting board"], [[0, 0, 5, 5], [40, 40, 50, 50],
                                                         [41, 41, 48, 48], [0, 0, 60, 60]]),
    (["plate", "jug", "plate", "person"], [[0, 0, 10, 10], [30, 0, 40, 10], [50, 50, 60, 60],
                                           [100, 100, 110, 110]]),
    (["hob", "water"], [[0, 0, 1, 1], [2, 2, 3, 3]]),
]
ANNOTATIONS = [("cut", ["cucumber"]), ("put", ["pepper"]), ("wash", ["plate"]), ("pour", ["water"]),
               ("gather", ["plate", "cucumber"]), ("take", ["hob"]), ("take", ["pepper", "plate"]),
               ("open", ["fridge"])]


@pytest.mark.parametrize("verb,nouns", ANNOTATIONS)
def test_matching_cases_match_jax(verb, nouns):
    """match_frame_in_annotation (verb cases, obj-only, closest to hand,
    put, all instances, side matches, no_matches) on each row, and the
    case helpers, as JAX's."""
    ann = pd.Series({"verb": verb, "all_nouns": nouns})
    for classes, boxes in ROWS:
        row = det_row(classes, boxes)
        assert T.match_frame_in_annotation(row, ann, SOFT) == J.match_frame_in_annotation(row, ann, SOFT)
        labels = [c for n in nouns for c in SOFT.get(n, {}).get("default", [])]
        for name in ("_get_closest_to_hands", "_get_put_obj_matches"):
            assert getattr(T, name)(labels, row) == getattr(J, name)(labels, row)
        for name in ("_get_first_match", "_get_all_matches"):
            assert getattr(T, name)(labels, row["Classes"]) == getattr(J, name)(labels, row["Classes"])


def test_label_video_matches_jax():
    """label_video with and without the row NMS, and a video of one
    annotation, as JAX's frames."""
    for version in (0, 1):
        pd.testing.assert_frame_equal(T.label_video(_detections(), _annots(), SOFT, version),
                                      J.label_video(_detections(), _annots(), SOFT, version))
    got = T.label_video(_detections(), _annots().iloc[:1], SOFT)
    assert len(got) == 0 and list(got.columns) == list(J.label_video(_detections(), _annots().iloc[:1],
                                                                      SOFT).columns)


def test_rows_and_csv_files_match_jax(tmp_path):
    """class_display_names, detections_to_rows (extra classes dropped,
    rounding, empty frames skipped), the CSV bytes, and the read-back by
    either package's read_detections_csv; the path helpers."""
    label_file = {"categories": [{"name": n} for n in ("Plate_", "_Person", "Watch_x", "cup__big")]}
    names = T.class_display_names(label_file)
    assert names == J.class_display_names(label_file)
    rng = np.random.default_rng(3)
    per_frame = [(np.array([0, 1, 2, 3]), rng.uniform(0, 1, 4), rng.uniform(0, 90, (4, 4))),
                 (np.array([2]), np.array([0.9]), np.array([[0, 0, 1, 1.0]])),
                 (np.array([3, 0]), rng.uniform(0, 1, 2), rng.uniform(0, 90, (2, 4)))]
    rows = T.detections_to_rows([7, 8, 9], per_frame, names)
    assert rows == J.detections_to_rows([7, 8, 9], per_frame, names) and len(rows) == 2
    df = pd.DataFrame(rows, columns=["Frame_no", "Classes", "Scores", "Bboxes"])
    T.write_detections_csv(df, tmp_path / "port" / "v_detections.csv")
    J.write_detections_csv(df, tmp_path / "jax" / "v_detections.csv")
    port_csv = tmp_path / "port" / "v_detections.csv"
    assert port_csv.read_bytes() == (tmp_path / "jax" / "v_detections.csv").read_bytes()
    pd.testing.assert_frame_equal(T.read_detections_csv(port_csv), J.read_detections_csv(port_csv))
    assert T.detections_csv_path(tmp_path, "v.mp4") == J.detections_csv_path(tmp_path, "v.mp4")
    for version, epic in ((2, False), (2, True), ("", False)):
        assert T.nao_csv_path(tmp_path, "v", version, epic) == J.nao_csv_path(tmp_path, "v", version, epic)


def test_label_subcommand_matches_jax(tmp_path):
    """``label`` writes JAX's CSV and pickle for the same inputs."""
    det_csv = tmp_path / "vid_detections.csv"
    rows = _detections().reset_index()
    for col in ("Classes", "Scores", "Bboxes"):
        rows[col] = rows[col].apply(lambda a: a.tolist())
    rows.to_csv(det_csv, index=False)
    _annots().to_pickle(tmp_path / "annots.pkl")
    (tmp_path / "soft.json").write_text(json.dumps({"epic": SOFT}))
    outs = {}
    for name, mod in (("port", T), ("jax", J)):
        mod.main(["label", "--detections-csv", str(det_csv), "--annotations-pkl",
                  str(tmp_path / "annots.pkl"), "--video", "vid", "--soft-matches", str(tmp_path / "soft.json"), "--out-dir",
                  str(tmp_path / name), "--dataset", "epic", "--version", "1"])
        outs[name] = tmp_path / name / "vid_nao_1"
    assert outs["port"].with_suffix(".csv").read_bytes() == outs["jax"].with_suffix(".csv").read_bytes()
    pd.testing.assert_frame_equal(pd.read_pickle(outs["port"].with_suffix(".pkl")),
                                  pd.read_pickle(outs["jax"].with_suffix(".pkl")))
    assert sorted(pd.read_pickle(outs["port"].with_suffix(".pkl")).index) == [50, 150]


def test_extract_subcommand_end_to_end_on_the_cpu(cli_env, tmp_path, monkeypatch):  # noqa: F811
    """``extract --device cpu`` over one video's frames of the synthetic
    dataset, batches of 3: the CSV is JAX's rows of what the detector
    returned, byte for byte, and JAX's reader reads it; the summary counts
    the frames and each stage's ms; without --device (no CUDA here) it
    raises resolve_device's error before anything runs."""
    from transfusion_torch.runner.trainer import EgoNaoTrainer

    few_test_proposals(monkeypatch)
    outs = []
    make = EgoNaoTrainer.make_detect_fn

    def spy(self, *args, **kwargs):
        fn = make(self, *args, **kwargs)

        def detect(images):
            outs.append(fn(images))
            return outs[-1]

        detect.timer = fn.timer
        return detect

    monkeypatch.setattr(EgoNaoTrainer, "make_detect_fn", spy)
    frames = os.path.join(os.environ["DATA"], "Ego4d", "v1", "object_frames")
    names = ["background"] + [f"noun{i}" for i in range(1, 7)] + ["watch"]
    (tmp_path / "labels.json").write_text(json.dumps({"categories": [{"name": n} for n in names]}))
    argv = ["extract", "--frames-dir", frames, "--video", "vid-0001", "--out-dir", str(tmp_path / "out"),
            "--config", cli_env["config"], "--label-file", str(tmp_path / "labels.json"),
            "--batch-size", "3", "--score-thresh", "0.0"]
    summary = T.main([*argv, "--device", "cpu"])
    ids = sorted(int(f[len("vid-0001_"):-4]) for f in os.listdir(frames) if f.startswith("vid-0001_"))
    assert summary["frames"] == len(ids) == 7 and len(outs) == 3
    assert set(summary["stage_ms"]) == {"decode", "detect", "transform", "device"}
    want = pd.DataFrame(J.detections_to_rows(ids, [d for batch in outs for d in batch], names),
                        columns=["Frame_no", "Classes", "Scores", "Bboxes"])
    J.write_detections_csv(want, tmp_path / "want.csv")
    assert open(summary["out"], "rb").read() == (tmp_path / "want.csv").read_bytes()
    assert summary["rows"] == len(want) > 0
    pd.testing.assert_frame_equal(J.read_detections_csv(summary["out"]),
                                  T.read_detections_csv(summary["out"]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.main(argv)
