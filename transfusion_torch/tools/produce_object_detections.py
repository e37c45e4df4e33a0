"""Strip a prediction JSON to its bare ``results`` dict — the input format of
the Ego4D SlowFast TTC predictor (``runner/utils/produce_object_detections.py``).

Port of ``transfusion_tpu/tools/produce_object_detections.py``.
"""

from __future__ import annotations

import argparse
import json
import os


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--input-path", type=str, required=True)
    parser.add_argument("--output-path", type=str, default=None)
    args = parser.parse_args(argv)
    if not args.output_path:
        args.output_path = args.input_path.rsplit(".", 1)[0] + "__object_detections.json"
    with open(args.input_path) as fp:
        data = json.load(fp)
    with open(args.output_path, "w") as fp:
        json.dump(data["results"], fp)
    print(f"Wrote {len(data['results'])} keys to {os.path.abspath(args.output_path)}")


if __name__ == "__main__":
    main()
