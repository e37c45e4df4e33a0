"""EPIC-KITCHENS / EGTEA NAO ingestion: the label-extraction round trip
(port of ``transfusion_tpu/data/epic_nao.py``; pandas, Pillow and the
transforms are imported inside the functions that use them).

The reference's legacy heatmap (snao) training consumes the OUTPUT of the
label-extraction pipeline: per-actor/video ``*_nao[_v].{csv,pkl}`` frames of
``[Frame_no, Classes, Scores, Bboxes, nao_clip_id, nao_narration,
nao_start_sec, det_sec]`` rows produced by matching a detector sweep against
narration annotations. Reference behavior rebuilt here:

  * dataset roots (``data_preprocessing/utils/path_constants.py:5-12``) and
    per-actor directories (``path_utils.py:18-31``);
  * per-actor NAO annotation loading (``path_utils.py:193-206``; the csv
    round-trip reader is the label tool's
    ``tools/label_extraction.py::read_detections_csv``);
  * det_diff filtering with the take_double two-pick variant
    (``dataset_utils.py:17-46``);
  * the merge with the narration-annotations frame that attaches noun/verb
    metadata per nao_clip_id (``base_nao_dataset.py:77-105``);
  * multi-dataset dispatch by underscore-joined name
    (``runner/utils/utils.py:37-49`` ``get_datasets_from_name``).

REACHABILITY NOTE: in the reference snapshot this path cannot actually run —
``get_annotations_df`` raises ``Exception(dataset_name not recognized)`` for
epic/egtea (``path_utils.py:82-102``), so the merge at
``base_nao_dataset.py:81-90`` is dead code. The rebuild closes the loop by
taking the SAME narration-annotations frame the ``label`` CLI consumes
(columns ``narration_id, verb, all_nouns/noun, narration, start_frame``) as
the metadata source, so ``extract -> label -> ingest -> train`` works end to
end with no external files.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable

import numpy as np

from transfusion_torch.tools.label_extraction import read_detections_csv

# path_constants.py:5-12 (ego4d roots live in runner.trainer.dataset_root).
EPIC_EGTEA_DATA_ROOTS = {
    "egtea": "$DATA/EGTEAp",
    "epic": "$DATA/EK",
    "epicv": "$DATA/EK",
}


def get_datasets_from_name(dataset_name: str) -> list[str]:
    """``epic_egtea`` -> ["epic", "egtea"] (utils.py:37-49)."""
    return dataset_name.split("_")


def actor_dir(data_root: str | Path, dataset_name: str, actor: str) -> Path:
    """Per-actor directory layout (path_utils.py:18-31)."""
    root = Path(os.path.expandvars(str(data_root)))
    if dataset_name in ("epic", "epicv"):
        return root / "data" / actor
    if dataset_name == "egtea":
        return root / "videos" / actor
    raise ValueError(f"dataset_name={dataset_name!r} not recognized.")


def load_actor_nao(actor_path: str | Path, actor: str, version: str | int = ""):
    """Every NAO annotation frame under one actor directory.

    The reference reads a single ``{actor}_nao[_v].pkl`` (path_utils.py:193-206);
    the rebuild's ``label`` CLI writes one ``{video}_nao[_v].{csv,pkl}`` per
    video (tools/label_extraction.nao_csv_path), so both shapes load: any
    ``*_nao{suffix}.pkl`` (csv fallback) in the directory, with the filename
    stem's prefix recorded as the ``video`` column."""
    import pandas as pd

    actor_path = Path(actor_path)
    suffix = f"_nao_{version}" if str(version) != "" else "_nao"
    frames = []
    seen = set()
    for ext in ("pkl", "csv"):
        for p in sorted(actor_path.glob(f"*{suffix}.{ext}")):
            video = p.name[: -len(f"{suffix}.{ext}")]
            if video in seen:
                continue  # pkl preferred over its csv twin
            seen.add(video)
            if ext == "pkl":
                df = pd.read_pickle(p)
                if df.index.name != "Frame_no" and "Frame_no" in df.columns:
                    df = df.set_index("Frame_no")
            else:
                df = read_detections_csv(p)
            df = df.copy()
            df["video"] = video
            df["actor"] = actor
            frames.append(df)
    if not frames:
        return pd.DataFrame(
            columns=["Classes", "Scores", "Bboxes", "nao_clip_id", "nao_narration",
                     "nao_start_sec", "det_sec", "video", "actor"])
    return pd.concat(frames)


def filter_nao_annotations(df, offset: float, take_double: bool = False):
    """det_diff computation + per-clip frame selection (dataset_utils.py:17-46):
    keep detections at least ``offset`` seconds before the narration; without
    take_double only the closest frame per clip survives; with it, a second
    frame at least 0.35 s earlier than the first is also kept."""
    import pandas as pd

    df = df.copy()
    df["det_diff"] = df["nao_start_sec"] - df["det_sec"]
    df = df[df["det_diff"] > offset]
    if df.empty:
        return df

    def closest(d):
        min_diff = d.groupby("nao_clip_id")["det_diff"].min()
        merged = d.reset_index().merge(min_diff, on="nao_clip_id", suffixes=("", "_min"))
        merged = merged[merged["det_diff"] == merged["det_diff_min"]]
        return merged.drop(columns=["det_diff_min"]).set_index("Frame_no")

    first = closest(df)
    if not take_double:
        return first
    gap = 0.35  # dataset_utils.py:25
    rest = df.reset_index().merge(
        first.reset_index()[["nao_clip_id", "det_diff"]],
        on="nao_clip_id", suffixes=("", "_prev"),
    ).set_index("Frame_no")
    rest = rest[rest["det_diff"] > rest["det_diff_prev"] + gap].drop(columns=["det_diff_prev"])
    second = closest(rest) if len(rest) else rest
    return pd.concat([first, second])


def load_nao_dataset_frame(
    dataset_name: str,
    annotations,
    data_root: str | Path | None = None,
    actors: list[str] | None = None,
    offset_s: float = 0.25,
    version: str | int = "",
    take_double: bool = False,
):
    """Assembled per-sample frame for the snao family (base_nao_dataset.py:77-105):
    per-actor NAO loads -> det_diff filter -> merge of noun/verb/narration
    metadata from ``annotations`` (indexed or columned by ``narration_id``).

    ``annotations`` is the same narration-annotations frame ``label_video``
    consumed; ``noun`` falls back to the first entry of ``all_nouns`` when no
    explicit noun column exists (the label CLI's input schema)."""
    import pandas as pd

    if data_root is None:
        data_root = EPIC_EGTEA_DATA_ROOTS[dataset_name]
    root = Path(os.path.expandvars(str(data_root)))
    if actors is None:
        parent = root / ("data" if dataset_name in ("epic", "epicv") else "videos")
        actors = sorted(p.name for p in parent.iterdir() if p.is_dir()) if parent.is_dir() else []

    parts = [
        load_actor_nao(actor_dir(root, dataset_name, a), a, version) for a in actors
    ]
    parts = [p for p in parts if len(p)]
    if not parts:
        raise FileNotFoundError(
            f"no *_nao{'_' + str(version) if str(version) != '' else ''} files under "
            f"{root} for actors {actors}"
        )
    nao = filter_nao_annotations(pd.concat(parts), offset_s, take_double)

    meta = annotations.reset_index()
    if "noun" not in meta.columns and "all_nouns" in meta.columns:
        meta = meta.assign(noun=meta["all_nouns"].apply(
            lambda ns: ns[0] if isinstance(ns, (list, tuple, np.ndarray)) and len(ns) else ""))
    cols = [c for c in ("narration_id", "verb", "noun", "narration") if c in meta.columns]
    merged = (
        nao.reset_index()
        .merge(meta[cols], left_on="nao_clip_id", right_on="narration_id")
        .drop(columns=["narration_id"])
    )
    merged["dataset"] = dataset_name
    return merged


def default_frame_path(root: Path, dataset_name: str, row) -> Path:
    """Frame file convention: ``{actor_dir}/{video}/frame_{Frame_no:07d}.jpg``
    (the extract CLI's flat ``{video}_{frame:07d}.jpg`` layout is also
    probed)."""
    adir = actor_dir(root, dataset_name, row["actor"])
    p = adir / str(row["video"]) / f"frame_{int(row['Frame_no']):07d}.jpg"
    if p.is_file():
        return p
    return adir / f"{row['video']}_{int(row['Frame_no']):07d}.jpg"


@dataclass
class EpicNaoDataset:
    """EgoNaoDataset-compatible view over a merged EPIC/EGTEA NAO frame so
    :class:`transfusion_torch.data.snao.SNaoDataset` (and MergedNaoDataset)
    can wrap it unchanged: ``get_example`` yields image/boxes/nouns/verbs/
    ttcs/id/narration with the snao TTC being det_diff (the
    seconds-to-narration gap the reference regresses)."""

    annots: Any  # a pandas DataFrame: load_nao_dataset_frame's output
    dataset_name: str
    aug: Any  # transforms.AugConfig
    noun_mapping: dict
    verb_mapping: dict
    data_root: str | Path | None = None
    frame_path_fn: Callable | None = None
    _root: Path = field(init=False)

    def __post_init__(self):
        self.annots = self.annots.reset_index(drop=True)
        self._root = Path(os.path.expandvars(str(
            self.data_root if self.data_root is not None
            else EPIC_EGTEA_DATA_ROOTS[self.dataset_name])))

    def __len__(self):
        return len(self.annots)

    @property
    def num_nouns(self) -> int:
        return max(self.noun_mapping.values()) + 1

    @property
    def num_verbs(self) -> int:
        return max(self.verb_mapping.values()) + 1

    def get_example(self, idx: int, rng: np.random.Generator, bucket, training: bool) -> dict:
        from PIL import Image

        from transfusion_torch.data.transforms import transform_example

        row = self.annots.iloc[idx]
        path = (self.frame_path_fn or default_frame_path)(self._root, self.dataset_name, row)
        img = np.asarray(Image.open(path).convert("RGB"))
        boxes = np.asarray(row["Bboxes"], np.float32).reshape(-1, 4)
        image, boxes = transform_example(rng, img, boxes, self.aug, bucket, training)
        noun = self.noun_mapping.get(str(row.get("noun", "")), 0)
        verb = self.verb_mapping.get(str(row.get("verb", "")), 0)
        n = len(boxes)
        return {
            "image": image,
            "boxes": boxes,
            "nouns": np.full((n,), noun, np.int32),
            "verbs": np.full((n,), verb, np.int32),
            "ttcs": np.full((n,), np.float32(row["det_diff"]), np.float32),
            "valid": np.ones((n,), bool),
            "id": f"{row['video']}_{int(row['Frame_no']):07d}",
            "narration": str(row.get("narration", row.get("nao_narration", ""))),
        }
