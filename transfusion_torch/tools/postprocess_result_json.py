"""Offline prediction-JSON corrector.

Post-hoc version of the in-model "additional postprocessing"
(``runner/utils/postprocess_result_json.py:99-196``): per frame, normalize
scores into a distribution, replace verbs of (noun, verb) pairs unseen in
training by the most frequent train verb for that noun (preferring a verb
already predicted with a seen pair for the same noun in this frame, for the
top-5 positions), clamp TTC to >= 0.251, and greedily drop detections whose
box intersects an already-kept detection with the same (noun, verb).

Port of ``transfusion_tpu/tools/postprocess_result_json.py``.
"""

from __future__ import annotations

import argparse
import json
import os
from os.path import expandvars, join


def _iou(a, b) -> float:
    x1, y1 = max(a[0], b[0]), max(a[1], b[1])
    x2, y2 = min(a[2], b[2]), min(a[3], b[3])
    if x2 < x1 or y2 < y1:
        return 0.0
    inter = (x2 - x1) * (y2 - y1)
    area_a = (a[2] - a[0]) * (a[3] - a[1])
    area_b = (b[2] - b[0]) * (b[3] - b[1])
    return inter / float(area_a + area_b - inter)


def noun_verb_freqs_from_annotations(train_json: dict) -> dict[int, dict[int, int]]:
    freqs: dict[int, dict[int, int]] = {}
    for annot in train_json["annotations"]:
        for obj in annot["objects"]:
            n, v = obj["noun_category_id"], obj["verb_category_id"]
            freqs.setdefault(n, {})[v] = freqs.get(n, {}).get(v, 0) + 1
    return freqs


def postprocess_results(results: dict, noun_verb_freqs: dict, min_ttc: float = 0.251) -> dict:
    """Apply the correction to a {uid: [entries]} dict (entries mutated)."""
    out = {}
    for frame_id, entries in results.items():
        score_sum = sum(e["score"] for e in entries) or 1.0
        order = sorted(
            range(len(entries)), key=lambda i: -(entries[i]["score"] / score_sum)
        )

        # Frame-wise (noun -> verb) counts over seen train pairs.
        frame_noun_verbs: dict[int, dict[int, int]] = {}
        for i in order:
            n, v = entries[i]["noun_category_id"], entries[i]["verb_category_id"]
            if noun_verb_freqs.get(n, {}).get(v, 0) > 0:
                frame_noun_verbs.setdefault(n, {})[v] = frame_noun_verbs.get(n, {}).get(v, 0) + 1
        frame_top = {
            n: max(vs.items(), key=lambda kv: kv[1])[0] for n, vs in frame_noun_verbs.items()
        }

        kept = []
        kept_boxes: dict[tuple, list] = {}
        for pos, i in enumerate(order):
            e = entries[i]
            n, v = e["noun_category_id"], e["verb_category_id"]
            if noun_verb_freqs.get(n, {}).get(v, 0) == 0:
                train_verbs = sorted(noun_verb_freqs.get(n, {}).items(), key=lambda kv: -kv[1])
                if train_verbs:
                    top_verb = train_verbs[0][0]
                    if n in frame_top and pos <= 4:
                        top_verb = frame_top[n]
                    e["verb_category_id"] = top_verb

            e["time_to_contact"] = max(min_ttc, e["time_to_contact"])
            box = e["box"]
            if not (box[0] < box[2] and box[1] < box[3]):
                continue
            key = (e["noun_category_id"], e["verb_category_id"])
            if any(_iou(box, other) > 0.0 for other in kept_boxes.get(key, [])):
                continue
            kept.append(e)
            kept_boxes.setdefault(key, []).append(box)
        out[frame_id] = kept
    return out


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--json-path", type=str, required=True)
    parser.add_argument("--annotation-dir", type=str, default=None)
    parser.add_argument("--output-path", type=str, default=None)
    args = parser.parse_args(argv)

    with open(args.json_path) as fp:
        input_dict = json.load(fp)
    if not args.annotation_dir:
        version = "v1" if len(input_dict["results"]) < 20000 else "v2"
        args.annotation_dir = expandvars(f"${{DATA}}/Ego4d/{version}/annotations")
    if not args.output_path:
        args.output_path = args.json_path.rsplit(".", 1)[0] + "_corrected.json"

    with open(join(args.annotation_dir, "fho_sta_train.json")) as fp:
        freqs = noun_verb_freqs_from_annotations(json.load(fp))

    out = {
        **{k: input_dict[k] for k in ("version", "challenge") if k in input_dict},
        "results": postprocess_results(input_dict["results"], freqs),
    }
    with open(args.output_path, "w") as fp:
        json.dump(out, fp)
    print(f"Output written to {os.path.abspath(args.output_path)}")


if __name__ == "__main__":
    main()
