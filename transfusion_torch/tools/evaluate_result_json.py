"""Offline evaluation of a prediction JSON against Ego4D STA annotations.

Fills the gap the reference documents but never ships
(``README.md:59`` references a missing ``evaluate_wandb_jsons.py``): fuse any
number of (possibly per-shard) prediction JSONs and score them with the
8-measure STA mAP suite against ``fho_sta_{split}.json`` ground truth —
reproducing the official evaluator's numbers without a wandb round trip.

Port of ``transfusion_tpu/tools/evaluate_result_json.py``. It scores with
the port's ``STAMeanAveragePrecision``.
"""

from __future__ import annotations

import argparse
import json
from os.path import join

import numpy as np

from transfusion_torch.metrics import STAMeanAveragePrecision


def load_gt(annotation_path: str) -> dict[str, dict]:
    with open(annotation_path) as fp:
        data = json.load(fp)
    gt = {}
    for annot in data["annotations"]:
        boxes, nouns, verbs, ttcs = [], [], [], []
        for obj in annot["objects"]:
            boxes.append(obj["box"])
            nouns.append(obj["noun_category_id"])
            verbs.append(obj["verb_category_id"])
            ttcs.append(obj["time_to_contact"])
        gt[annot["uid"]] = {
            "boxes": np.asarray(boxes, np.float64),
            "nouns": np.asarray(nouns),
            "verbs": np.asarray(verbs),
            "ttcs": np.asarray(ttcs, np.float64),
        }
    return gt


def evaluate_results(results: dict, gt: dict, top_k: int = 5) -> dict[str, float]:
    metric = STAMeanAveragePrecision(top_k=top_k)
    missing = 0
    for uid, labels in gt.items():
        entries = results.get(uid)
        if entries is None:
            missing += 1
            entries = []
        preds = {
            "boxes": np.asarray([e["box"] for e in entries], np.float64).reshape(-1, 4),
            "scores": np.asarray([e["score"] for e in entries], np.float64),
            "nouns": np.asarray([e["noun_category_id"] for e in entries]),
            "verbs": np.asarray([e["verb_category_id"] for e in entries]),
            "ttcs": np.asarray([e["time_to_contact"] for e in entries], np.float64),
        }
        metric.add(preds, labels)
    values = dict(zip(metric.get_short_names(), metric.evaluate()))
    if missing:
        values["_uids_without_predictions"] = missing
    return values


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("jsons", nargs="+", help="prediction JSON(s); shards are fused")
    parser.add_argument("--annotation-dir", required=True)
    parser.add_argument("--split", default="val")
    parser.add_argument("--top-k", type=int, default=5)
    args = parser.parse_args(argv)

    results: dict = {}
    for p in args.jsons:
        with open(p) as fp:
            data = json.load(fp)
        results.update(data.get("results", data))

    gt = load_gt(join(args.annotation_dir, f"fho_sta_{args.split}.json"))
    values = evaluate_results(results, gt, args.top_k)
    print(json.dumps({k: round(v, 5) if isinstance(v, float) else v for k, v in values.items()}, indent=1))


if __name__ == "__main__":
    main()
