"""Frame and feature readers (port of ``transfusion_tpu/data/readers.py``).

Host-side counterparts of ``data_preprocessing/datasets/readers.py``:
pre-extracted JPG frames (the shipped path), MP4 seek-read, LMDB jpg bytes
and LMDB float32 feature blobs (SlowFast clip features), the optical-flow
JPEGs of the dual-stream model, and the clip frame-index computation of
``video_readers.py:25-47``. Pillow, OpenCV and ``lmdb`` are imported inside
the functions that use them, so the trainer runs without them.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np


class Ego4dJpgReader:
    """{video}_{frame:07d}.jpg files in one directory (readers.py:31-50)."""

    def __init__(self, data_path: str, video_id: str | None = None):
        self.data_path = str(data_path)
        self.video_id = video_id

    def get_frame(self, frame_no: int, video_id: str | None = None) -> np.ndarray:
        from PIL import Image

        vid = video_id or self.video_id
        path = os.path.join(self.data_path, f"{vid}_{int(frame_no):07d}.jpg")
        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"))


class Ego4dMp4Reader:
    """cv2 seek-read on a full-scale video (readers.py:53-126)."""

    def __init__(self, video_path: str):
        import cv2

        self.path = str(video_path)
        self._cap = cv2.VideoCapture(self.path)

    def get_frame(self, frame_no: int) -> np.ndarray:
        import cv2

        self._cap.set(cv2.CAP_PROP_POS_FRAMES, frame_no)
        ok, frame = self._cap.read()
        if not ok:
            raise IOError(f"frame {frame_no} unreadable in {self.path}")
        return cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)

    def get_img_shape(self):
        import cv2

        h = int(self._cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        w = int(self._cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        return h, w, 3

    def close(self):
        self._cap.release()


def _open_lmdb(path) -> object:
    import lmdb  # optional dependency

    return lmdb.open(str(path), readonly=True, lock=False, readahead=False, meminit=False)


class Ego4dLmdbReader:
    """jpg bytes keyed by '{video}_{frame:07d}' in an LMDB (readers.py:129-210).
    Requires the optional ``lmdb`` package."""

    def __init__(self, lmdb_path: str, video_id: str | None = None):
        self.env = _open_lmdb(lmdb_path)
        self.video_id = video_id

    def get_frame(self, frame_no: int, video_id: str | None = None) -> np.ndarray:
        import io

        from PIL import Image

        vid = video_id or self.video_id
        key = f"{vid}_{int(frame_no):07d}".encode()
        with self.env.begin(write=False) as txn:
            buf = txn.get(key)
        if buf is None:
            raise KeyError(key)
        with Image.open(io.BytesIO(bytes(buf))) as im:
            return np.asarray(im.convert("RGB"))


class SlowFastFeaturesReader:
    """float32 feature vectors keyed by frame id in an LMDB (readers.py:325-346)."""

    def __init__(self, lmdb_path: str, feature_dim: int = 2304):
        self.env = _open_lmdb(lmdb_path)
        self.feature_dim = feature_dim

    def get(self, key: str) -> np.ndarray | None:
        with self.env.begin(write=False) as txn:
            buf = txn.get(key.encode())
        if buf is None:
            return None
        return np.frombuffer(bytes(buf), np.float32).reshape(-1, self.feature_dim)


FLOW_IMG_SHAPE_UP = (360, 480, 2)  # HWC
JPG_FLOW_LOAD_SHAPE = (2, 480, 640)  # CHW as stored


def decode_flow_jpg(buf: bytes, load_shape=JPG_FLOW_LOAD_SHAPE,
                    img_shape=FLOW_IMG_SHAPE_UP) -> np.ndarray:
    """Decode one packed flow JPEG: a grayscale image stacking the two flow
    channels vertically -> reshape CHW -> HWC [H, W, 2], bilinear-resized to
    ``img_shape`` when stored at another resolution."""
    import cv2

    raw = np.frombuffer(buf, np.uint8)
    flat = cv2.imdecode(raw, cv2.IMREAD_GRAYSCALE)
    val = flat.reshape(load_shape).transpose(1, 2, 0)
    th, tw = img_shape[:2]
    if val.shape[:2] != (th, tw):
        val = cv2.resize(val, dsize=(tw, th), interpolation=cv2.INTER_LINEAR)
    return val


class FlowJpgReader:
    """Optical-flow frames packed as grayscale JPEGs in a per-video LMDB
    (``FlowDataReaderJpg``, readers.py:300-322): keys use the 10-digit frame
    template and the LMDB directory carries a ``_jpg`` suffix."""

    def __init__(self, path_to_root: str, video_id: str,
                 load_shape=JPG_FLOW_LOAD_SHAPE, img_shape=FLOW_IMG_SHAPE_UP):
        self.video_id = video_id
        self.load_shape = tuple(load_shape)
        self.img_shape = tuple(img_shape)
        self.env = _open_lmdb(Path(path_to_root) / f"{video_id}_jpg")

    def _key(self, frame_no: int) -> bytes:
        return f"{self.video_id}_{int(frame_no):010d}".encode()

    def _decode(self, buf: bytes) -> np.ndarray:
        return decode_flow_jpg(bytes(buf), self.load_shape, self.img_shape)

    def get_frame(self, frame_no: int) -> np.ndarray:
        with self.env.begin(write=False) as txn:
            buf = txn.get(self._key(frame_no))
        if buf is None:
            raise KeyError(self._key(frame_no))
        return self._decode(buf)

    def get_clip(self, frames: list[int]) -> list[np.ndarray]:
        with self.env.begin(write=False) as txn:
            return [self._decode(txn.get(self._key(f))) for f in frames]

    def existing_keys(self) -> set[str]:
        with self.env.begin(write=False) as txn:
            return {k.decode("ascii") for k in txn.cursor().iternext(values=False)}

    def check_frames_exist(self, frames) -> bool:
        keys = self.existing_keys()
        return all(self._key(f).decode("ascii") in keys for f in frames)


def get_clip_frame_idxs(end_frame: int, num_frames: int, stride: int) -> list[int]:
    """Backward strided clip indices ending at end_frame (video_readers.py:25-35)."""
    return [max(0, end_frame - i * stride) for i in range(num_frames - 1, -1, -1)]


def get_clip_frame_idxs_block(end_frame: int, num_frames: int, stride: int, block: int) -> list[int]:
    """Block sampling: ``block`` consecutive frames at each strided anchor
    (video_readers.py:38-47)."""
    out = []
    for i in range(num_frames - 1, -1, -1):
        anchor = max(0, end_frame - i * stride)
        out.extend(max(0, anchor + j) for j in range(block))
    return out


def slowfast_feature_window(frame_idx: int, contact_frame: int | None, window: int, stride: int,
                            avoid_leak: bool = True) -> list[int]:
    """Feature frame indices for a sample, excluding frames at/after the
    contact frame when leak avoidance is on (slowfast_features_dsets.py:71-105)."""
    idxs = get_clip_frame_idxs(frame_idx, window, stride)
    if avoid_leak and contact_frame is not None:
        idxs = [i for i in idxs if i < contact_frame]
        if not idxs:
            idxs = [max(0, (contact_frame or 1) - 1)]
    return idxs
