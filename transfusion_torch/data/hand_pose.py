"""FrankMocap hand-pose/box features per frame (port of
``transfusion_tpu/data/hand_pose.py``, with the zero-filled stand-in of
``transfusion_tpu/runner/trainer.py::_ZeroHandLookup``).

Host-side equivalent of ``modeling/hand_pos_dataset.py``: a pickle cache
``{video_id: {frame_idx: frankmocap_record}}`` yields, per sample, a history
of ``num_steps`` frames (stride ``step`` backwards from the sample frame) for
both hands — normalized boxes [2*steps, 4] and 63-d joint vectors
[2*steps, 63], zero-filled where the cache has no detection.
"""

from __future__ import annotations

import pickle

import numpy as np

HAND_FEAT_DIM = 21 * 3
SIDES = ("left_hand", "right_hand")


class HandPoseLookup:
    def __init__(self, cache_path: str, num_steps: int = 5, step: int = 5):
        with open(cache_path, "rb") as fp:
            self.cache = pickle.load(fp)
        self.num_steps = num_steps
        self.step = step

    def _frame_vecs(self, record, side: str):
        w, h = record["image_width"], record["image_height"]
        bbox = np.asarray(record["hand_bbox_list"][0][side], np.float64)
        box = np.concatenate([bbox[:2], bbox[:2] + bbox[2:]]) / np.array([w, h, w, h])
        joints = np.asarray(record["pred_output_list"][0][side]["pred_joints_img"], np.float64)
        pose = (joints / np.array([w, h, 100.0])).reshape(-1)
        return box.astype(np.float32), pose.astype(np.float32)

    def get(self, video_id: str, frame_idx: int):
        """Returns (hand_boxes [2*steps, 4], hand_poses [2*steps, 63])."""
        n = self.num_steps
        boxes = np.zeros((2 * n, 4), np.float32)
        poses = np.zeros((2 * n, HAND_FEAT_DIM), np.float32)
        video = self.cache.get(video_id)
        if video is None:
            return boxes, poses
        frames = [max(0, frame_idx - s * self.step) for s in range(n)]
        for hand_idx, side in enumerate(SIDES):
            for step_idx, f in enumerate(frames):
                record = video.get(f)
                if not record:
                    continue
                preds = record.get("pred_output_list")
                if not preds or len(preds) != 1 or not preds[0].get(side):
                    continue
                pos = n * hand_idx + step_idx
                boxes[pos], poses[pos] = self._frame_vecs(record, side)
        return boxes, poses


class ZeroHandLookup:
    """Zero-filled hand history where the FrankMocap cache is missing: the
    transformer TTC head sees all-zero hands, as the reference's zero-fill
    of a frame without a detection gives."""

    def __init__(self, num_steps: int = 5):
        self.num_steps = num_steps

    def get(self, video_id: str, frame_idx: int):
        n = 2 * self.num_steps
        return np.zeros((n, 4), np.float32), np.zeros((n, HAND_FEAT_DIM), np.float32)
