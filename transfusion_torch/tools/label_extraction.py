"""NAO label extraction: detection sweep + narration-guided label matching
(port of ``transfusion_tpu/tools/label_extraction.py``).

Rebuild of the reference's ``data_preprocessing/label_extraction/`` package
(label_extraction.py, nao_labeling.py, nao_labeling_cases.py, utils.py).
That package is NOT runnable in the reference snapshot: every module imports
a dead ``Code.`` package prefix (label_extraction.py:23-28), so this rebuild
is behavior-from-source, verified by unit tests rather than by oracle runs.

Two stages, mirroring the reference's two ``__main__`` scripts:

1. **Detection sweep** (label_extraction.py:92-125): run an object detector
   over a video's frames and persist one CSV row per frame:
   ``[Frame_no, Classes, Scores, Bboxes]`` (class *names*, not ids). The
   reference drives a frozen UniDet model; here the detector is a pluggable
   ``detect_fn`` — by default the framework's own trained FasterRCNN
   (``EgoNaoTrainer.make_detect_fn``: one batched eval forward on the
   card, ``cuda`` unless ``--device`` names another, instead of a torch
   DataLoader around a detectron2 predictor).
2. **NAO labeling** (nao_labeling.py + nao_labeling_cases.py): for every
   consecutive pair of narration annotations in a video, scan the detection
   rows between their start frames and mark detections matching the *next*
   annotation's nouns/verb (via a curated soft-match dictionary) as
   next-active-object ground truth.

Soft-match dictionary schema (one entry per dataset, nao_labeling.py:212-213):

    {
      "no_matches": [nouns to ignore entirely],
      "actions": {
        "obj_only":              [verbs matched through their object nouns],
        "take_closest_to_hand":  [verbs resolved by hand proximity],
        "take_all_instances":    [verbs keeping every instance],
        <verb>: ["obj"?, label, ...]   # per-verb extra target labels
      },
      <noun>: {"default": [labels by priority], <verb>: [side labels]}
    }

Reference quirks reproduced or cited:

* ``match_frame_in_annotation`` accepts a ``version`` argument whose
  docstring promises three behaviors (nao_labeling.py:69-70) but the body
  never reads it — dispatch is driven entirely by the soft-match dict
  contents (nao_labeling_cases.py:12-61). We keep the argument for parity
  and likewise ignore it.
* The row-level NMS keeps detections in *input order* — it never sorts by
  score (label_extraction/utils.py:86-95). Preserved.
* ``_verb_parse_case`` treats ``verb_soft_matches[1:]`` as extra labels only
  when the literal string "obj" is a member, assuming "obj" is the first
  element (nao_labeling_cases.py:77-78). Preserved.
* Hard-coded ``print("debu")`` debug hooks (nao_labeling.py:75-76,
  nao_labeling_cases.py:23-32) are dead scaffolding — dropped.

pandas is imported inside the functions that use it.

    python -m transfusion_torch.tools.label_extraction extract \
        --frames-dir DIR --video VID --out-dir OUT --config RUN.yml \
        --label-file LABELS.json [--checkpoint CKPT] [--device cuda|cpu]
    python -m transfusion_torch.tools.label_extraction label \
        --detections-csv CSV --annotations-pkl PKL --video VID \
        --soft-matches SOFT.json --out-dir OUT
"""

from __future__ import annotations

import argparse
import ast
import json
import logging
import os
from pathlib import Path

import numpy as np

from transfusion_torch.utils.profiling import StepTimer

HAND_LABEL = "person"  # nao_labeling_cases.py:9
DEFAULT_EXTRA_CLASSES = frozenset({"bracelet", "watch"})  # utils.py:53


# ---------------------------------------------------------------------------
# Box math (numpy equivalents of the detectron2 helpers the reference uses).
# ---------------------------------------------------------------------------

def pairwise_intersection(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Intersection areas [len(a), len(b)] for xyxy boxes
    (detectron2 ``pairwise_intersection`` semantics)."""
    a = np.asarray(a, np.float32).reshape(-1, 4)
    b = np.asarray(b, np.float32).reshape(-1, 4)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0.0, None)
    return wh[..., 0] * wh[..., 1]


def pairwise_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a = np.asarray(a, np.float32).reshape(-1, 4)
    b = np.asarray(b, np.float32).reshape(-1, 4)
    inter = pairwise_intersection(a, b)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def pairwise_point_box_distance(points: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """Signed distances [P, B, 4] of each point to each box's (left, top,
    right, bottom) edge, positive inside (detectron2
    ``pairwise_point_box_distance`` semantics)."""
    points = np.asarray(points, np.float32).reshape(-1, 2)
    boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
    x, y = points[:, None, 0], points[:, None, 1]
    x1, y1, x2, y2 = boxes[None, :, 0], boxes[None, :, 1], boxes[None, :, 2], boxes[None, :, 3]
    return np.stack([x - x1, y - y1, x2 - x, y2 - y], axis=2)


def nms_row(classes: np.ndarray, scores: np.ndarray, boxes: np.ndarray,
            iou_lim: float = 0.4):
    """Greedy input-order suppression of one detections row
    (label_extraction/utils.py:73-109). Note: the reference deliberately
    keeps detector output order — it does NOT sort by score first."""
    classes = np.asarray(classes)
    scores = np.asarray(scores, np.float32)
    boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
    keep_c, keep_s, keep_b = [], [], []
    idx = np.arange(len(boxes))
    while len(idx):
        cur = idx[0]
        keep_c.append(classes[cur])
        keep_s.append(scores[cur])
        keep_b.append(boxes[cur])
        idx = idx[1:]
        if not len(idx):
            break
        ious = pairwise_iou(boxes[cur][None], boxes[idx])[0]
        idx = idx[ious <= iou_lim]
    return np.asarray(keep_c), np.asarray(keep_s, np.float32), np.asarray(keep_b, np.float32).reshape(-1, 4)


# ---------------------------------------------------------------------------
# Matching cases (nao_labeling_cases.py).
# ---------------------------------------------------------------------------

def _get_first_match(labels: list, det_classes: np.ndarray) -> list[int]:
    """First detection of the highest-priority label present
    (nao_labeling_cases.py:187-201)."""
    for label in labels or []:
        hits = np.where(np.asarray(det_classes) == label)[0]
        if len(hits):
            return [int(hits[0])]
    return []


def _get_all_matches(labels: list, det_classes: np.ndarray) -> list[int]:
    """All detections of the first three labels; the tail labels only count
    when the head found nothing (nao_labeling_cases.py:170-184)."""
    if not labels:
        return []
    det_classes = np.asarray(det_classes)
    idxs: list[int] = []
    for label in labels[:3]:
        idxs += np.where(det_classes == label)[0].tolist()
    if not idxs:
        for label in labels[3:]:
            idxs += np.where(det_classes == label)[0].tolist()
    return [int(i) for i in idxs]


def _hand_positions(row) -> np.ndarray:
    return np.where(np.asarray(row["Classes"]) == HAND_LABEL)[0]


def _get_closest_to_hands(labels: list, row) -> list[int]:
    """The single candidate nearest a detected hand: largest hand overlap, or
    (if nothing overlaps) the candidate minimizing its worst edge distance to
    any hand box (nao_labeling_cases.py:111-136)."""
    if not labels:
        return []
    hands = _hand_positions(row)
    if not len(hands):
        return []
    cands = _get_all_matches(labels, row["Classes"])
    if not cands:
        return []
    boxes = np.asarray(row["Bboxes"], np.float32).reshape(-1, 4)
    inters = pairwise_intersection(boxes[cands], boxes[hands])
    if inters.max() == 0:
        centers = np.stack([(boxes[cands, 0] + boxes[cands, 2]) / 2,
                            (boxes[cands, 1] + boxes[cands, 3]) / 2], axis=1)
        dists = pairwise_point_box_distance(centers, boxes[hands])
        worst = np.max(dists, axis=2)  # [cands, hands]
        best = int(np.unravel_index(np.argmin(worst), worst.shape)[0])
    else:
        best = int(np.unravel_index(np.argmax(inters), inters.shape)[0])
    return [cands[best]]


def _get_put_obj_matches(labels: list, row) -> list[int]:
    """'put' resolves to the candidate overlapping a hand, or nothing
    (nao_labeling_cases.py:147-167)."""
    if not labels:
        return []
    hands = _hand_positions(row)
    if not len(hands):
        return []
    cands = _get_all_matches(labels, row["Classes"])
    if not cands:
        return []
    boxes = np.asarray(row["Bboxes"], np.float32).reshape(-1, 4)
    inters = pairwise_intersection(boxes[cands], boxes[hands])
    if inters.max() == 0:
        return []
    return [cands[int(np.unravel_index(np.argmax(inters), inters.shape)[0])]]


def _get_match_processor(verb: str, actions: dict):
    """nao_labeling_cases.py:100-108."""
    if verb == "put":
        return _get_put_obj_matches
    if verb in actions.get("take_closest_to_hand", []):
        return _get_closest_to_hands
    if verb in actions.get("take_all_instances", []):
        return _get_all_matches
    return _get_first_match


def _run_processor(processor, labels, row) -> list[int]:
    # first/all matchers look only at class names; hand-aware ones need the row.
    if processor in (_get_first_match, _get_all_matches):
        return processor(labels, row["Classes"])
    return processor(labels, row)


def _verb_parse_case(verb: str, row, annotation, soft_matches: dict) -> list[int]:
    """Verb-driven matching (nao_labeling_cases.py:64-97)."""
    actions = soft_matches["actions"]
    verb_matches = actions.get(verb, [])
    processor = _get_match_processor(verb, actions)

    if verb in actions.get("obj_only", []) or "obj" in verb_matches:
        # Reference convention: "obj" is the sentinel first element; the tail
        # holds extra target labels (nao_labeling_cases.py:77-78).
        verb_ext = list(verb_matches[1:]) if "obj" in verb_matches else []
        idxs: list[int] = []
        for noun in annotation["all_nouns"]:
            noun_matches = soft_matches.get(noun, {})
            idxs += _run_processor(processor, noun_matches.get("default", []), row)
            verb_ext = list(noun_matches.get(verb, [])) + verb_ext
        idxs += _run_processor(processor, verb_ext, row)
        if verb == "cut":
            knife = soft_matches.get("knife", {"default": ["knife"]})["default"]
            idxs += _run_processor(processor, knife, row)
        return sorted(set(idxs))
    return _run_processor(processor, verb_matches, row)


def match_frame_in_annotation(row, curr_annotation, soft_matches: dict,
                              version: int = 1) -> list[int]:
    """Indices of the detections in ``row`` matching ``curr_annotation``
    (nao_labeling_cases.py:12-61). ``version`` is accepted for parity with
    the reference signature and, like the reference body, unused."""
    del version
    verb = str(curr_annotation["verb"]).lower()
    actions = soft_matches["actions"]
    if (verb in actions or verb in actions.get("obj_only", [])
            or verb in actions.get("take_closest_to_hand", [])):
        return sorted(set(_verb_parse_case(verb, row, curr_annotation, soft_matches)))

    idxs: list[int] = []
    for noun in curr_annotation["all_nouns"]:
        if noun in soft_matches.get("no_matches", []):
            return []
        noun_matches = soft_matches.get(noun, {})
        idxs += _get_first_match(noun_matches.get("default", []), row["Classes"])
        if verb in noun_matches:
            # Side matches: "put pepper" also accepts the cutting board
            # (nao_labeling_cases.py:53-56).
            idxs += _get_first_match(noun_matches.get(verb, []), row["Classes"])
    return sorted(set(idxs))


# ---------------------------------------------------------------------------
# Per-annotation / per-video labeling (nao_labeling.py).
# ---------------------------------------------------------------------------

def get_nao_labels_for_annotation(frames_slice, annotation, soft_matches: dict,
                                  version: int = 1):
    """Rows of ``frames_slice`` with at least one matching detection, each
    reduced to its matching subset (nao_labeling.py:57-101)."""
    import pandas as pd

    matches = frames_slice.apply(
        match_frame_in_annotation, curr_annotation=annotation,
        soft_matches=soft_matches, version=version, axis=1)
    nonempty = matches.str.len() > 0
    rows = []
    for (index, det_row), pair in zip(frames_slice[nonempty].iterrows(), matches[nonempty]):
        rows.append({
            "Frame_no": index,
            "Classes": np.asarray(det_row["Classes"])[pair].tolist(),
            "Scores": np.asarray(det_row["Scores"])[pair].tolist(),
            "Bboxes": np.asarray(det_row["Bboxes"]).reshape(-1, 4)[pair].tolist(),
        })
    df = pd.DataFrame(rows, columns=["Frame_no", "Classes", "Scores", "Bboxes"])
    return df.set_index("Frame_no"), frames_slice[nonempty]


def get_nao_labels_for_video(detections_df, video_annotations, soft_matches: dict,
                             version: int = 1):
    """NAO labels for one video: detections strictly between consecutive
    annotation start frames are matched against the LATER annotation
    (nao_labeling.py:27-54). ``video_annotations`` needs columns
    [start_frame, narration_id, narration, starting_ms, fps, verb, all_nouns]."""
    import pandas as pd

    video_annotations = video_annotations.sort_values(by=["start_frame"])
    fps = video_annotations["fps"].median()
    out = []
    for ann_no, (_, annotation) in enumerate(video_annotations.iloc[1:].iterrows()):
        lo = video_annotations.iloc[ann_no]["start_frame"]
        hi = annotation["start_frame"]
        sl = detections_df[(detections_df.index > lo) & (detections_df.index < hi)]
        if not len(sl):
            continue
        labels, _ = get_nao_labels_for_annotation(sl, annotation, soft_matches, version)
        labels["nao_clip_id"] = annotation["narration_id"]
        labels["nao_narration"] = annotation["narration"]
        labels["nao_start_sec"] = annotation["starting_ms"] / 1000
        labels["det_sec"] = labels.index / fps
        out.append(labels)
    if not out:
        return pd.DataFrame(
            columns=["Classes", "Scores", "Bboxes", "nao_clip_id",
                     "nao_narration", "nao_start_sec", "det_sec"])
    return pd.concat(out)


def label_video(detections_df, video_annotations, soft_matches: dict, version: int = 1,
                nms_iou: float | None = 0.4):
    """End-to-end per-video labeling: optional row NMS (the reference applies
    it for every version != 0, nao_labeling.py:141-143) then matching."""
    import pandas as pd

    annots = video_annotations.copy()
    annots["all_nouns"] = annots["all_nouns"].apply(
        lambda nouns: [x for x in nouns if x not in soft_matches.get("no_matches", [])])
    if nms_iou is not None and version != 0:
        kept = detections_df.apply(
            lambda r: nms_row(r["Classes"], r["Scores"], r["Bboxes"], nms_iou),
            axis=1, result_type="expand")
        detections_df = kept.rename(columns={0: "Classes", 1: "Scores", 2: "Bboxes"})
    if len(annots) <= 1:
        # Videos with a single annotation yield nothing (nao_labeling.py:146-150).
        return pd.DataFrame(
            columns=["Classes", "Scores", "Bboxes", "nao_clip_id",
                     "nao_narration", "nao_start_sec", "det_sec"])
    return get_nao_labels_for_video(detections_df, annots, soft_matches, version)


# ---------------------------------------------------------------------------
# Detection sweep (label_extraction.py) with a pluggable detector.
# ---------------------------------------------------------------------------

def class_display_names(label_file: dict) -> list[str]:
    """First non-empty '_'-token of every category name
    (utils.py:24-25 ``labels_to_classes``)."""
    return [next(t for t in cat["name"].split("_") if t != "")
            for cat in label_file["categories"]]


def detections_to_rows(frame_ids, per_frame_dets, class_names,
                       extra_classes=DEFAULT_EXTRA_CLASSES) -> list[dict]:
    """One CSV row per frame with any kept detection; classes stored as
    display names, extra classes (jewelry etc.) dropped case-insensitively,
    scores/boxes rounded to 3 decimals (utils.py:38-70)."""
    rows = []
    for frame, (classes, scores, boxes) in zip(frame_ids, per_frame_dets):
        names = [class_names[int(c)] for c in np.asarray(classes).tolist()]
        keep = [i for i, n in enumerate(names) if n.lower() not in extra_classes]
        if not keep:
            continue
        rows.append({
            "Frame_no": int(frame),
            "Classes": [names[i] for i in keep],
            "Scores": np.round(np.asarray(scores, np.float64)[keep], 3).tolist(),
            "Bboxes": np.round(np.asarray(boxes, np.float64).reshape(-1, 4)[keep], 3).tolist(),
        })
    return rows


def extract_detections_for_video(detect_fn, read_frame, frame_ids, class_names,
                                 batch_size: int = 8,
                                 extra_classes=DEFAULT_EXTRA_CLASSES, timer: StepTimer | None = None):
    """Sweep ``frame_ids`` through ``detect_fn`` in batches
    (label_extraction.py:92-125, with the torch DataLoader replaced by a
    plain batched host loop feeding one batched forward).

    ``detect_fn(images: [B, H, W, 3] uint8) -> list of (class_ids, scores,
    xyxy boxes)`` per image, already confidence-thresholded. ``timer``
    records each batch's ``decode`` (reading the frames) and ``detect``
    seconds.
    """
    import pandas as pd

    timer = timer if timer is not None else StepTimer()
    all_rows: list[dict] = []
    for lo in range(0, len(frame_ids), batch_size):
        chunk = frame_ids[lo:lo + batch_size]
        with timer.stage("decode"):
            images = np.stack([read_frame(f) for f in chunk])
        with timer.stage("detect"):
            dets = detect_fn(images)
        all_rows.extend(detections_to_rows(chunk, dets, class_names, extra_classes))
    return pd.DataFrame(all_rows, columns=["Frame_no", "Classes", "Scores", "Bboxes"])


def detections_csv_path(actor_dir: Path, video_name: str) -> Path:
    """label_extraction.py:55-59."""
    return Path(actor_dir) / f"{str(video_name).replace('.mp4', '')}_detections.csv"


def nao_csv_path(actor_dir: Path, name: str, version, epic_video: bool = False,
                 ext: str = "csv") -> Path:
    """path_utils.py:152-160."""
    if version != "":
        suffix = f"_nao_{version}_video" if epic_video else f"_nao_{version}"
    else:
        suffix = "_nao"
    return Path(actor_dir) / f"{name}{suffix}.{ext}"


def write_detections_csv(df, path: Path) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    df.to_csv(path, index=False)


def read_detections_csv(path: Path, index: str = "Frame_no"):
    """Round-trip loader: list columns parse via literal_eval, empty rows
    drop, class names lowercase (path_utils.py:128-142)."""
    import pandas as pd

    df = pd.read_csv(path, converters={
        "Scores": lambda x: np.array(ast.literal_eval(x)),
        "Classes": lambda x: np.array(ast.literal_eval(x)),
        "Bboxes": lambda x: np.array(ast.literal_eval(x)),
    }).set_index(index)
    df = df[df["Classes"].str.len() > 0]
    df["Classes"] = df["Classes"].apply(lambda x: np.array([el.lower() for el in x]))
    return df


# ---------------------------------------------------------------------------
# CLI: `extract` sweeps a detector over frames, `label` matches annotations.
# ---------------------------------------------------------------------------

def _build_framework_detect_fn(config_path: str, checkpoint: str | None,
                               score_thresh: float, run_dir: str, device=None):
    """Default detector: this framework's FasterRCNN at eval settings, on
    ``device`` (``cuda`` unless it names another; no fallback)."""
    from transfusion_torch.config.derive import derive_config
    from transfusion_torch.config.loader import load_config
    from transfusion_torch.runner.trainer import EgoNaoTrainer  # lazy: heavy

    cfg = derive_config(load_config(config_path))
    trainer = EgoNaoTrainer(cfg, run_dir=run_dir, device=device)
    return trainer.make_detect_fn(score_thresh=score_thresh, resume_from=checkpoint)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_ex = sub.add_parser("extract", help="sweep a detector over video frames")
    p_ex.add_argument("--frames-dir", required=True,
                      help="directory of {video}_{frame:07d}.jpg frames")
    p_ex.add_argument("--video", required=True)
    p_ex.add_argument("--out-dir", required=True)
    p_ex.add_argument("--config", required=True)
    p_ex.add_argument("--checkpoint", default=None,
                      help="checkpoint directory to restore (default: model.pretrained)")
    p_ex.add_argument("--label-file", required=True,
                      help="JSON with {categories: [{name}...]}")
    p_ex.add_argument("--score-thresh", type=float, default=0.4)
    p_ex.add_argument("--batch-size", type=int, default=8)
    p_ex.add_argument("--device", default=None,
                      help="torch device of the detector (default cuda; raises without one)")

    p_lb = sub.add_parser("label", help="match detections against annotations")
    p_lb.add_argument("--detections-csv", required=True)
    p_lb.add_argument("--annotations-pkl", required=True,
                      help="pandas pickle with one row per narration annotation")
    p_lb.add_argument("--video", required=True)
    p_lb.add_argument("--soft-matches", required=True)
    p_lb.add_argument("--out-dir", required=True)
    p_lb.add_argument("--dataset", default="epic")
    p_lb.add_argument("--version", type=int, default=1)
    p_lb.add_argument("--epic-video", action="store_true")

    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    if args.cmd == "extract":
        from transfusion_torch.data.readers import Ego4dJpgReader

        with open(os.path.expandvars(args.label_file)) as fp:
            label_file = json.load(fp)
        reader = Ego4dJpgReader(args.frames_dir, args.video)
        prefix = f"{args.video}_"
        frame_ids = sorted(
            int(p.stem[len(prefix):]) for p in Path(args.frames_dir).glob(f"{prefix}*.jpg")
        )
        detect_fn = _build_framework_detect_fn(
            args.config, args.checkpoint, args.score_thresh,
            run_dir=os.path.join(args.out_dir, "_detector_run"), device=args.device)
        timer = StepTimer()
        df = extract_detections_for_video(
            detect_fn, reader.get_frame, frame_ids,
            class_display_names(label_file), args.batch_size, timer=timer)
        out = detections_csv_path(Path(args.out_dir), args.video)
        write_detections_csv(df, out)
        stage_ms = {**timer.report(), **getattr(detect_fn, "timer", StepTimer()).report()}
        logging.info("wrote %s (%d rows); ms a batch %s", out, len(df), stage_ms)
        return {"out": str(out), "rows": len(df), "frames": len(frame_ids), "stage_ms": stage_ms}
    import pandas as pd

    with open(os.path.expandvars(args.soft_matches)) as fp:
        soft_all = json.load(fp)
    soft = soft_all.get(args.dataset, soft_all)
    detections = read_detections_csv(args.detections_csv)
    annots = pd.read_pickle(args.annotations_pkl)
    labels = label_video(detections, annots, soft, args.version)
    out = nao_csv_path(Path(args.out_dir), args.video, args.version, args.epic_video)
    Path(out).parent.mkdir(parents=True, exist_ok=True)
    labels.to_csv(out)
    labels.to_pickle(str(out)[: -len("csv")] + "pkl")
    logging.info("wrote %s (%d rows)", out, len(labels))
    return {"out": str(out), "rows": len(labels)}


if __name__ == "__main__":
    main()
