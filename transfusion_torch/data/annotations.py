"""Ego4D STA annotation ingestion (host-side pandas; port of
``transfusion_tpu/data/annotations.py``, pandas imported by the loaders).

Behavioral mirror of ``data_preprocessing/utils/annotations_df_utils.py``:
parses ``fho_sta_{train,val}.json`` + ``fho_sta_test_unannotated.json`` into
one DataFrame indexed by uid with the exact derived columns the rest of the
stack consumes:

  * per-annotation box/verb/noun lists and ``det_diff`` (the json's
    time_to_contact — the reference keeps the LAST object's value, a quirk
    preserved here, ``annotations_df_utils.py:160-170``);
  * optional 480p box rescale for LMDB-extracted frames (``:172-187``);
  * degenerate-box rows dropped (summed area <= 1, ``:188``);
  * v2 noun-id disambiguations (nut tool/food, measurement tape/tape) and
    the v1 'indument'->'cloth' rename; verb 68/69 -> turn-off/turn-on
    (``:190-220``); names truncated at the first '_';
  * ``episode_action_id`` action segmentation by det_diff resets within a
    clip (``:243-254``);
  * synthetic ``nao_narration`` "verb noun and ..." strings (``:256-267``);
  * external-caption narration templating ``{external_i}``/``{gt_narr}``
    (``path_utils.py:62-79``);
  * the 5 corrupt uids dropped (``:104-114``).
"""

from __future__ import annotations

import itertools
import json
import os
from pathlib import Path
from typing import TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:
    import pandas as pd

CORRUPT_UIDS = [
    "77ed1624-f87b-4196-9a0a-95b7023b18e4_0000220",
    "d18ef16d-f803-4387-bb5e-7876f1522a63_0023565",
    "77ed1624-f87b-4196-9a0a-95b7023b18e4_0000205",
    "77ed1624-f87b-4196-9a0a-95b7023b18e4_0000190",
    "d18ef16d-f803-4387-bb5e-7876f1522a63_0023520",
]

V2_NOUN_OVERRIDES = {46: "nut tool", 101: "nut food", 76: "measurement tape", 121: "tape"}
VERB_OVERRIDES = {68: "turn-off", 69: "turn-on"}


def _boxes_area_sum(boxes: np.ndarray) -> float:
    if boxes.size == 0:
        return 0.0
    b = np.asarray(boxes, dtype=np.float64).reshape(-1, 4)
    return float(((b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])).sum())


def _noun_name(cat_id: int, categories: list, v2: bool) -> str:
    if v2 and cat_id in V2_NOUN_OVERRIDES:
        return V2_NOUN_OVERRIDES[cat_id]
    return categories[cat_id]["name"].split("_")[0]


def _verb_name(cat_id: int, categories: list) -> str:
    if cat_id in VERB_OVERRIDES:
        return VERB_OVERRIDES[cat_id]
    return categories[cat_id]["name"].split("_")[0]


def _episode_action_ids(clip_ids, det_diffs) -> list[str]:
    """Sequential action segmentation (annotations_df_utils.py:243-254)."""
    out = []
    cur = 0
    prev_clip, prev_diff = None, None
    for clip, diff in zip(clip_ids, det_diffs):
        if prev_clip is not None:
            if clip == prev_clip:
                if diff > prev_diff:
                    cur += 1
            else:
                cur = 0
        out.append(f"{clip}_{cur:04d}")
        prev_clip, prev_diff = clip, diff
    return out


def _nao_narration(all_verbs: list[str], all_nouns: list[str]) -> str:
    if len(all_nouns) > len(all_verbs):
        fill = all_verbs[0]
    else:
        fill = all_nouns[0]
    pairs = [" ".join(x) for x in itertools.zip_longest(all_verbs, all_nouns, fillvalue=fill)]
    return " and ".join(pairs)


def apply_narr_structure(uid: str, row, narr_structure: str, external_dicts: list[dict]) -> str:
    text = narr_structure
    repl = {
        "gt_noun": row["noun"],
        "gt_verb": row["verb"],
        "gt_narr": row["narration"],
        **{f"external_{i}": d.get(uid, "") for i, d in enumerate(external_dicts)},
    }
    for k, v in repl.items():
        text = text.replace("{" + k + "}", v)
    return " ".join(filter(len, text.split(" ")))


def load_sta_subset(data_root: str | Path, subset: str, resize_boxes: bool = False) -> pd.DataFrame:
    import pandas as pd

    data_root = Path(data_root)
    v2 = "v2" in str(data_root)
    uid_col = "video_uid" if v2 else "video_id"
    with open(data_root / "annotations" / f"fho_sta_{subset}.json") as fp:
        annot_json = json.load(fp)

    nouns_cat = annot_json["noun_categories"]
    for entry in nouns_cat:
        if entry["name"] == "indument":
            entry["name"] = "cloth"
            break
    verbs_cat = annot_json["verb_categories"]
    meta = annot_json["info"]["video_metadata"]

    rows = []
    for ann in annot_json["annotations"]:
        boxes, verb_ids, noun_ids = [], [], []
        ttc = 0.0
        for obj in ann["objects"]:
            boxes.append(obj["box"])
            verb_ids.append(obj["verb_category_id"])
            noun_ids.append(obj["noun_category_id"])
            ttc = obj["time_to_contact"]
        boxes = np.asarray(boxes, dtype=np.float64)

        vm = meta[ann[uid_col]]
        if resize_boxes:
            boxes = boxes / (vm["frame_height"] / 480.0)
        if _boxes_area_sum(boxes) <= 1:
            continue

        all_nouns = [_noun_name(c, nouns_cat, v2) for c in noun_ids]
        all_verbs = [_verb_name(c, verbs_cat) for c in verb_ids]
        fps = vm["fps"]
        rows.append(
            {
                "uid": ann["uid"],
                uid_col: ann[uid_col],
                "Frame_no": ann["frame"],
                "clip_id": ann["clip_id"],
                "Bboxes": boxes,
                "verb_ids": verb_ids,
                "noun_ids": noun_ids,
                "det_diff": ttc,
                "all_nouns": all_nouns,
                "all_verbs": all_verbs,
                "noun": all_nouns[0],
                "verb": all_verbs[0],
                "fps": fps,
                "nao_clip_id": ann["uid"],
                "episode_id": ann["uid"],
                "start_frame": ann["frame"],
                "det_sec": ann["frame"] / fps,
                "orig_split": subset,
                "frame_height": vm["frame_height"],
                "frame_width": vm["frame_width"],
            }
        )

    df = pd.DataFrame(rows).set_index("uid")
    df["episode_action_id"] = _episode_action_ids(df["clip_id"].tolist(), df["det_diff"].tolist())
    df["nao_narration"] = [
        _nao_narration(v, n) for v, n in zip(df["all_verbs"], df["all_nouns"])
    ]
    df["narration"] = df["nao_narration"]
    return df


def load_sta_test_unannotated(data_root: str | Path) -> pd.DataFrame:
    """Test set with dummy labels (annotations_df_utils.py:78-101)."""
    import pandas as pd

    data_root = Path(data_root)
    with open(data_root / "annotations" / "fho_sta_test_unannotated.json") as fp:
        annot_json = json.load(fp)
    meta = annot_json["info"]["video_metadata"]
    rows = []
    for ann in annot_json["annotations"]:
        vid = ann.get("video_uid", ann.get("video_id"))
        vm = meta[vid]
        rows.append(
            {
                "uid": ann["uid"],
                ("video_uid" if "video_uid" in ann else "video_id"): vid,
                "Frame_no": ann["frame"],
                "clip_id": ann.get("clip_id", ann["uid"]),
                "Bboxes": np.array([[17.0, 3.0, 190.0, 960.0]]),
                "verb_ids": [0],
                "noun_ids": [0],
                "det_diff": 0.0,
                "all_nouns": ["ball"],
                "all_verbs": ["take"],
                "noun": "ball",
                "verb": "take",
                "fps": vm["fps"],
                "nao_clip_id": ann["uid"],
                "episode_id": ann["uid"],
                "episode_action_id": ann["uid"],
                "start_frame": ann["frame"],
                "nao_narration": "test_set_nao_narration",
                "narration": "test_set_narration",
                "det_sec": ann["frame"] / vm["fps"],
                "orig_split": "test",
                "frame_height": vm["frame_height"],
                "frame_width": vm["frame_width"],
            }
        )
    return pd.DataFrame(rows).set_index("uid")


def load_sta_annotations(
    data_root: str | Path,
    resize_boxes: bool = False,
    narr_structure: str = "{gt_narr}",
    narr_external_paths: list[str] = (),
) -> pd.DataFrame:
    """Full ingestion: train + val + test, corrupt uids dropped, narration
    templated from external caption JSONs."""
    import pandas as pd

    parts = [
        load_sta_subset(data_root, "train", resize_boxes),
        load_sta_subset(data_root, "val", resize_boxes),
    ]
    test_path = Path(data_root) / "annotations" / "fho_sta_test_unannotated.json"
    if test_path.exists():
        parts.append(load_sta_test_unannotated(data_root))
    df = pd.concat(parts, axis=0)
    df = df[~df.index.isin(CORRUPT_UIDS)]

    external_dicts = []
    for p in narr_external_paths:
        if not os.path.exists(p):
            raise ValueError(f"{p} does not exist")
        with open(p) as fp:
            external_dicts.append(json.load(fp))

    df["narration"] = [
        apply_narr_structure(uid, row, narr_structure, external_dicts)
        for uid, row in df.iterrows()
    ]
    return df
