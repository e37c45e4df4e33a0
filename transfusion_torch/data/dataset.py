"""The Ego4D NAO dataset + narration context + static batch assembly (port of
``transfusion_tpu/data/dataset.py``: the egonao path's ``build_narration_lookup``,
``EgoNaoDataset`` and ``collate``; pandas and Pillow are imported where a
function reads files or frames, so ``collate`` needs neither).

Host-side counterpart of ``data_preprocessing/datasets/egonao_datasets.py`` +
the narration wrappers (``modeling/narration_embeds/datasets/*``) + collate
(``modeling/narration_embeds/collate_wrapper_utils.py``), restructured for a
TPU input pipeline: every batch is a dict of fixed-shape numpy arrays (image
at the bucket resolution, GT boxes padded to MAX_GT with a validity mask,
pre-tokenized language), ready for `jax.device_put`.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import TYPE_CHECKING

import numpy as np

from transfusion_torch.data.transforms import AugConfig, transform_example

if TYPE_CHECKING:
    import pandas as pd

MAX_GT = 8  # Ego4D STA images rarely exceed 3 next-active objects.


def build_narration_lookup(
    annots: pd.DataFrame,
    strategy: str = "current",
    start_prompt: str | None = None,
    end_prompt: str | None = None,
    empty_prompt: str | None = None,
    final_concat: str | None = None,
) -> dict[str, str]:
    """uid -> narration string.

    ``current``: the row's templated narration
    (``current_embeddings_dsets.py:78-95``). ``prev_k``: up to k previous
    action segments' narrations, walking ``episode_action_id`` backwards
    within the same clip (``previous_embeddings_dsets.py:117-165``).
    """
    lookup: dict[str, str] = {}
    if strategy == "current":
        for uid, row in annots.iterrows():
            narr = row["narration"]
            if start_prompt:
                narr = start_prompt + narr
            if end_prompt:
                narr = narr + end_prompt
            lookup[uid] = empty_prompt if (len(narr) == 0 and empty_prompt) else narr
        return lookup

    if strategy.startswith("prev"):
        k = int(strategy.split("_")[-1])
        ordered = annots.sort_values(["episode_action_id", "start_frame"])
        pos_of = {uid: i for i, uid in enumerate(ordered.index)}
        clip_ids = ordered["clip_id"].tolist()
        action_ids = ordered["episode_action_id"].tolist()
        narrations = ordered["narration"].tolist()

        for uid in annots.index:
            pos = pos_of[uid]
            clip = clip_ids[pos]
            action = action_ids[pos]
            narrs: list[str] = []
            idx = pos - 1
            while idx >= 0 and len(narrs) < k and clip_ids[idx] == clip:
                if action_ids[idx] == action:
                    idx -= 1
                    continue
                narrs.insert(0, narrations[idx])
                action = action_ids[idx]
                idx -= 1
            text = ", ".join(narrs)
            if final_concat and "," in text:
                text = final_concat.join(text.rsplit(",", 1))
            if start_prompt:
                text = start_prompt + text
            if end_prompt:
                text = text + end_prompt
            lookup[uid] = empty_prompt if (len(text) == 0 and empty_prompt) else text
        return lookup

    raise ValueError(f"unknown narration strategy {strategy}")


@dataclass
class EgoNaoDataset:
    """One split's samples: annotations + frame files + label mappings."""

    annots: pd.DataFrame
    frames_dir: str
    noun_mapping: dict[str, int]
    verb_mapping: dict[str, int]
    aug: AugConfig
    narration_lookup: dict[str, str]
    uid_col: str = "video_uid"
    verb_bg: bool = True

    def __len__(self):
        return len(self.annots)

    @property
    def num_nouns(self) -> int:
        return 1 + len(self.noun_mapping)  # +1 bg (egonao_datasets.py:96-97)

    @property
    def num_verbs(self) -> int:
        return len(self.verb_mapping) + (1 if self.verb_bg else 0)

    def frame_path(self, row) -> str:
        video = row[self.uid_col] if self.uid_col in row else row["video_id"]
        return os.path.join(self.frames_dir, f"{video}_{int(row['Frame_no']):07d}.jpg")

    def read_frame(self, row) -> np.ndarray:
        from PIL import Image

        with Image.open(self.frame_path(row)) as im:
            return np.asarray(im.convert("RGB"))

    def get_example(self, idx: int, rng: np.random.Generator, bucket, training: bool) -> dict:
        """One transformed sample; unreadable frames fall through to the next
        index (egonao_datasets.py:136-138)."""
        for attempt in range(len(self)):
            row = self.annots.iloc[(idx + attempt) % len(self)]
            try:
                img = self.read_frame(row)
                break
            except Exception:
                continue
        else:
            raise RuntimeError("no readable frames in dataset")

        orig_shape = img.shape[:2]
        image, boxes = transform_example(rng, img, row["Bboxes"], self.aug, bucket, training)
        uid = row.name
        return {
            "image": image,
            "boxes": boxes,
            "nouns": np.array([self.noun_mapping[n] for n in row["all_nouns"]], np.int32),
            "verbs": np.array([self.verb_mapping[v] for v in row["all_verbs"]], np.int32),
            "ttcs": np.full(len(row["all_nouns"]), row["det_diff"], np.float32),
            "id": uid,
            "orig_shape": orig_shape,
            "narration": self.narration_lookup.get(uid, ""),
        }


def collate(samples: list[dict], tokenizer=None, lang_max_length: int = 128) -> dict:
    """Static-shape batch: images stacked, targets padded to MAX_GT, language
    tokenized to fixed length."""
    bsz = len(samples)
    images = np.stack([s["image"] for s in samples])

    boxes = np.zeros((bsz, MAX_GT, 4), np.float32)
    nouns = np.zeros((bsz, MAX_GT), np.int32)
    verbs = np.zeros((bsz, MAX_GT), np.int32)
    ttcs = np.zeros((bsz, MAX_GT), np.float32)
    valid = np.zeros((bsz, MAX_GT), bool)
    for i, s in enumerate(samples):
        g = min(len(s["boxes"]), MAX_GT)
        boxes[i, :g] = s["boxes"][:g]
        nouns[i, :g] = s["nouns"][:g]
        verbs[i, :g] = s["verbs"][:g]
        ttcs[i, :g] = s["ttcs"][:g]
        valid[i, :g] = True

    batch = {
        "image": images,
        "targets": {
            "boxes": boxes,
            "nouns": nouns,
            "verbs": verbs,
            "ttcs": ttcs,
            "valid": valid,
        },
        "uids": [s["id"] for s in samples],
        "orig_hw": np.array([s["orig_shape"] for s in samples], np.int32),
    }
    if tokenizer is not None:
        texts = [s["narration"] for s in samples]
        type_names = getattr(tokenizer, "type_names", ())
        if type_names:
            # Inline `word<type>` markers -> per-token type mask
            # (narr_pooling_layers.py:119-186).
            ids, mask, tmask = tokenizer.encode_batch_with_types(texts, type_names, lang_max_length)
            batch["type_mask"] = tmask
        else:
            ids, mask = tokenizer.encode_batch(texts, lang_max_length)
        batch["input_ids"] = ids
        batch["attention_mask"] = mask
    return batch

