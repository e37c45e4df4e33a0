"""Merge external TTC predictions (Ego4D SlowFast pipeline output) into a
prediction JSON by per-frame score matching.

Working version of the reference's ``runner/utils/adapt_ttc_values.py`` —
that script ships unrunnable (``description=`` argparse kwargs, undefined
``test_keys`` at line 38); the matching rule is preserved: within each frame,
a detection takes the TTC of the first external prediction with an identical
score (consumed on match), defaulting to 0.5 when the external TTC is empty.

Port of ``transfusion_tpu/tools/adapt_ttc_values.py``.
"""

from __future__ import annotations

import argparse
import json
import os


def adapt_ttc(detections: dict, ttc_reference: dict, default_ttc: float = 0.5) -> dict:
    out = {}
    ref_results = {k: list(v) for k, v in ttc_reference.get("results", ttc_reference).items()}
    for uid, entries in detections.items():
        out[uid] = entries
        pool = ref_results.get(uid, [])
        for e in entries:
            for i, pred in enumerate(pool):
                if e["score"] == pred["score"]:
                    ttc = pred["time_to_contact"]
                    e["time_to_contact"] = default_ttc if ttc == [] else ttc
                    pool.pop(i)
                    break
    return out


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--input-path", type=str, required=True, help="prediction JSON (or bare results)")
    parser.add_argument("--ttc-reference-path", type=str, required=True,
                        help="output of the Ego4D SlowFast TTC pipeline")
    parser.add_argument("--output-path", type=str, default=None)
    args = parser.parse_args(argv)
    if not args.output_path:
        args.output_path = args.input_path.rsplit(".", 1)[0] + "__adapted_ttc.json"

    with open(args.input_path) as fp:
        data = json.load(fp)
    results = data.get("results", data)
    with open(args.ttc_reference_path) as fp:
        ttc_ref = json.load(fp)

    out = {
        "version": "1.0",
        "challenge": "ego4d_short_term_object_interaction_anticipation",
        "results": adapt_ttc(results, ttc_ref),
    }
    with open(args.output_path, "w") as fp:
        json.dump(out, fp)
    print(f"Wrote {len(out['results'])} keys to {os.path.abspath(args.output_path)}")


if __name__ == "__main__":
    main()
