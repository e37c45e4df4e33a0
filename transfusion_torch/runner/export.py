"""Ego4D STA prediction-JSON export + sharded-result fusion (port of
``transfusion_tpu/runner/export.py``).

Export follows the official challenge format the reference writes per epoch
(``runner/nao/ego_nao_trainer.py:195-250``): top-5 detections per uid with
boxes in original-resolution coordinates and the noun background/class-0 swap
undone. ``fuse_result_jsons`` fills the gap the reference documents but never
ships (``README.md:59`` references a missing ``evaluate_wandb_jsons.py``):
when eval shards across hosts, each host writes a partial JSON and the fused
file reproduces the exact single-host metric.
"""

from __future__ import annotations

import json
import os
from typing import Iterable

import numpy as np

CHALLENGE = "ego4d_short_term_object_interaction_anticipation"


def detections_to_results(
    dets: dict,
    uids: list[str],
    orig_hw: np.ndarray,
    image_hw: tuple[int, int],
    last_noun_idx: int,
    top_k: int = 5,
) -> dict:
    """Convert one batch of fixed-shape detections to {uid: [entry...]}.

    dets: arrays [B, K, ...] from postprocess (boxes in model-image coords);
    orig_hw: [B, 2] original (h, w) per image.
    """
    boxes = np.asarray(dets["boxes"])
    scores = np.asarray(dets["scores"])
    nouns = np.asarray(dets["nouns"])
    verbs = np.asarray(dets["verbs"])
    ttcs = np.asarray(dets["ttcs"])
    valid = np.asarray(dets["valid"])

    results = {}
    for i, uid in enumerate(uids):
        ry = orig_hw[i][0] / image_hw[0]
        rx = orig_hw[i][1] / image_hw[1]
        entries = []
        for j in range(boxes.shape[1]):
            if not valid[i, j]:
                continue
            if len(entries) >= top_k:
                break
            box = boxes[i, j] * np.array([rx, ry, rx, ry])
            noun = int(nouns[i, j])
            if noun == last_noun_idx:
                noun = 0  # undo the bg/class-0 swap (ego_nao_trainer.py:227-228)
            entries.append(
                {
                    "box": [float(v) for v in box],
                    "noun_category_id": noun,
                    "verb_category_id": int(verbs[i, j]),
                    "time_to_contact": float(ttcs[i, j]),
                    "score": float(scores[i, j]),
                }
            )
        results[uid] = entries
    return results


def write_result_json(results: dict, path: str, epoch: int | None = None) -> str:
    payload = {
        "version": "1.0",
        "challenge": CHALLENGE,
        **({"epoch": epoch} if epoch is not None else {}),
        "results": results,
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as fp:
        fp.write(json.dumps(payload))
    return path


def fuse_result_jsons(paths: Iterable[str], out_path: str) -> str:
    """Merge per-shard prediction JSONs (later shards win on duplicate uids,
    matching how a single host would have overwritten)."""
    fused: dict = {}
    meta = {"version": "1.0", "challenge": CHALLENGE}
    for p in paths:
        with open(p) as fp:
            data = json.load(fp)
        meta["version"] = data.get("version", meta["version"])
        fused.update(data.get("results", {}))
    return write_result_json(fused, out_path, None)
