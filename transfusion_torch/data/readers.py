"""Readers of the dual-stream model's inputs (port of the flow decoder of
``transfusion_tpu/data/readers.py``). OpenCV is imported inside the
function that decodes, so the trainer runs without it."""

from __future__ import annotations

import numpy as np

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
