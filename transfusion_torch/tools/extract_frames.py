"""Batched host-side prediction-frame extraction.

The BASELINE decode path: the reference's
``data_preprocessing/extract_prediction_frames.py:59-90`` seeks ONE frame per
``cv2.CAP_PROP_POS_FRAMES`` set-and-read, serially across all videos. This
version keeps the exact output contract ({video}_{frame:07d}.jpg, quality 95)
but:

  * sorts each video's needed frames and decodes them in ONE forward pass per
    video (sequential grab/retrieve between targets instead of re-seeking,
    which also avoids keyframe re-decoding);
  * fans videos out across a process pool (decode releases no GIL in cv2's
    demuxer, so processes, sized to the host).

Port of ``transfusion_tpu/tools/extract_frames.py``.
"""

from __future__ import annotations

import argparse
import json
import os
from collections import defaultdict
from concurrent.futures import ProcessPoolExecutor
from os.path import expandvars, isfile, join


def collect_frame_indices(annotation_dir: str) -> dict[str, list[int]]:
    by_video: dict[str, list[int]] = defaultdict(list)
    for name in ("fho_sta_train.json", "fho_sta_val.json"):
        path = join(annotation_dir, name)
        if not isfile(path):
            continue
        with open(path) as fp:
            data = json.load(fp)
        for annot in data["annotations"]:
            video_id, frame_idx = annot["uid"].rsplit("_", 1)
            by_video[video_id].append(int(frame_idx))
    return {k: sorted(set(v)) for k, v in by_video.items()}


def extract_video(video_path: str, frame_idxs: list[int], output_dir: str,
                  overwrite: bool = False, quality: int = 95) -> int:
    """Decode one video's target frames in a single monotonic pass."""
    import cv2
    from PIL import Image

    video_id = os.path.splitext(os.path.basename(video_path))[0]
    todo = [
        f for f in frame_idxs
        if overwrite or not isfile(join(output_dir, f"{video_id}_{f:07d}.jpg"))
    ]
    if not todo:
        return 0

    cap = cv2.VideoCapture(video_path)
    written = 0
    try:
        pos = 0
        for target in todo:
            # Jump only for large gaps; otherwise grab() forward (cheap).
            if target < pos or target - pos > 250:
                cap.set(cv2.CAP_PROP_POS_FRAMES, target)
                pos = target
            while pos < target:
                cap.grab()
                pos += 1
            ok, frame = cap.read()
            pos += 1
            if not ok:
                continue
            rgb = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            Image.fromarray(rgb).save(
                join(output_dir, f"{video_id}_{target:07d}.jpg"), quality=quality
            )
            written += 1
    finally:
        cap.release()
    return written


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--version", type=str, default="ego4dv2")
    parser.add_argument("--full-scale-dir", type=str, default=None)
    parser.add_argument("--annotation-dir", type=str, default=None)
    parser.add_argument("--output-dir", type=str, default=None)
    parser.add_argument("--workers", type=int, default=os.cpu_count() or 4)
    parser.add_argument("--overwrite", action="store_true")
    args = parser.parse_args(argv)

    v = "v1" if args.version.lower() in {"ego4d", "v1", "1"} else "v2"
    args.full_scale_dir = args.full_scale_dir or expandvars(f"${{DATA}}/Ego4d/{v}/full_scale")
    args.annotation_dir = args.annotation_dir or expandvars(f"${{DATA}}/Ego4d/{v}/annotations")
    args.output_dir = args.output_dir or expandvars(f"${{DATA}}/Ego4d/{v}/object_frames")
    os.makedirs(args.output_dir, exist_ok=True)

    by_video = collect_frame_indices(args.annotation_dir)
    print(f"{sum(map(len, by_video.values()))} frames across {len(by_video)} videos")

    total = 0
    with ProcessPoolExecutor(max_workers=args.workers) as pool:
        futures = [
            pool.submit(
                extract_video, join(args.full_scale_dir, f"{vid}.mp4"), idxs,
                args.output_dir, args.overwrite,
            )
            for vid, idxs in by_video.items()
        ]
        for f in futures:
            total += f.result()
    print(f"Wrote {total} frames to {args.output_dir}")


if __name__ == "__main__":
    main()
