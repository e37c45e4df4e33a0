"""Legacy snao heatmap dataset family (port of
``transfusion_tpu/data/snao.py``, over the port's ``EgoNaoDataset``).

``SNaoDataset`` (data_preprocessing/datasets/snao_datasets.py:140-255) views
NAO annotations as heatmap-regression samples: one image, one spatial target
built from the annotation's boxes (const / gaussian / normalized-gaussian,
heatmap math in :mod:`transfusion_torch.data.heatmaps`), one noun/verb label,
the det_diff TTC, and the constant fg/bg percentages the reference hardcodes
(base_nao_dataset.py:166-168: fg_perc = 0.5, bg_perc = 1 - fg_perc).

``PaperSNaoDataset`` (snao_datasets.py:257-300) is the EPIC paper-split
variant: same sample contract, different annotation filter (take_double
forced off, :302-306) — here that's just a pre-filtered annotations frame, so
it needs no separate class.

REACHABILITY: the snao experiment is dead code in the reference snapshot
(runner/utils/factories.py:11-20 only dispatches "egonao"); rebuilt with the
intended semantics so the heatmap family is runnable.

Deviation (documented): the reference renders the heatmap at the original
resolution and pushes it through the detectron2 resize transform
(snao_datasets.py:199-216); we render it AT the transformed resolution from
the transformed boxes — analytically the same target (both const-inside-box
and gaussians parameterized by relative box geometry commute with resize up
to interpolation error), one resize cheaper, and exact rather than blurred
for "const" (the reference rounds post-resize values back to {0, 1}).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np

from transfusion_torch.data.heatmaps import get_img_heatmap


@dataclass
class SNaoDataset:
    """Heatmap-target view over an :class:`EgoNaoDataset`'s annotations."""

    base: Any  # data.dataset.EgoNaoDataset, or data.epic_nao.EpicNaoDataset
    heatmap_type: str = "gaussian"  # run_args["heatmap_type"]

    def __len__(self):
        return len(self.base)

    @property
    def num_nouns(self) -> int:
        return self.base.num_nouns

    @property
    def num_verbs(self) -> int:
        return self.base.num_verbs

    def get_example(self, idx: int, rng: np.random.Generator, bucket,
                    training: bool) -> dict:
        s = self.base.get_example(idx, rng, bucket, training)
        h, w = s["image"].shape[:2]
        heatmap_fn = get_img_heatmap(self.heatmap_type)
        heatmap = heatmap_fn(np.asarray(s["boxes"], np.float32), h, w)
        return {
            "image": s["image"],
            "heatmap": heatmap.astype(np.float32),
            # snao annotations carry ONE noun/verb per sample
            # (nao_annots_keep_cols, snao_datasets.py:173-182).
            "noun": np.int32(s["nouns"][0]) if len(s["nouns"]) else np.int32(0),
            "verb": np.int32(s["verbs"][0]) if len(s["verbs"]) else np.int32(0),
            "ttc": np.float32(s["ttcs"][0]) if len(s["ttcs"]) else np.float32(0),
            "fg_perc": np.float32(0.5),  # base_nao_dataset.py:166-168
            "bg_perc": np.float32(0.5),
            "id": s["id"],
            "narration": s["narration"],
            **({"language_f": s["language_f"]} if "language_f" in s else {}),
        }


def snao_collate(samples: list[dict]) -> dict:
    """Batch dict for the heatmap trainer path (SNaoDataset.convert_example,
    snao_datasets.py:232-252): stacked image/heatmap plus scalar targets."""
    batch = {
        "image": np.stack([s["image"] for s in samples]),
        "heatmap": np.stack([s["heatmap"] for s in samples]),
        "noun": np.asarray([s["noun"] for s in samples], np.int32),
        "verb": np.asarray([s["verb"] for s in samples], np.int32),
        "ttc": np.asarray([s["ttc"] for s in samples], np.float32),
        "fg_perc": np.asarray([s["fg_perc"] for s in samples], np.float32),
        "bg_perc": np.asarray([s["bg_perc"] for s in samples], np.float32),
        "uids": [s["id"] for s in samples],
    }
    if "language_f" in samples[0]:
        batch["language_f"] = np.stack([s["language_f"] for s in samples])
    return batch
