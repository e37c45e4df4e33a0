"""Online per-channel mean/std over a frame directory
(``data_preprocessing/compute_norm_stats.py`` equivalent).

Port of ``transfusion_tpu/tools/compute_norm_stats.py``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def compute_stats(frames_dir: str, limit: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    from PIL import Image

    count = 0
    s1 = np.zeros(3, np.float64)
    s2 = np.zeros(3, np.float64)
    files = sorted(f for f in os.listdir(frames_dir) if f.endswith(".jpg"))
    if limit:
        files = files[:limit]
    for name in files:
        with Image.open(os.path.join(frames_dir, name)) as im:
            x = np.asarray(im.convert("RGB"), np.float64) / 255.0
        s1 += x.sum(axis=(0, 1))
        s2 += (x * x).sum(axis=(0, 1))
        count += x.shape[0] * x.shape[1]
    mean = s1 / count
    std = np.sqrt(s2 / count - mean**2)
    return mean, std


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--frames-dir", required=True)
    parser.add_argument("--limit", type=int, default=None)
    args = parser.parse_args(argv)
    mean, std = compute_stats(args.frames_dir, args.limit)
    print(f"mean: {mean.tolist()}\nstd: {std.tolist()}")


if __name__ == "__main__":
    main()
