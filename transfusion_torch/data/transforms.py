"""Host-side image augmentation pipeline (numpy/cv2; port of
``transfusion_tpu/data/transforms.py``, OpenCV imported by the functions that
use it, with the same numpy draws in the same order).

Covers the reference's augmentation chain for the egonao experiment
(``runner/utils/data_transforms.py``): detectron2-style relative-range
RandomCrop + RandomFlip + RGB->BGR ChannelPermutation on the raw uint8 image
(boxes transformed alongside), then torchvision-semantics ColorJitter and
ego4d_baseline (caffe BGR) normalization, and finally — in place of the
reference's in-model ``NoNormTransform`` multiscale resize
(``modeling/obj_detection/wrapper_utils.py:51-81``) — a bilinear resize to
one of the discrete (h, w) buckets so every device batch is a static shape.

One deliberate deviation for TPU: the reference samples a resize bucket per
IMAGE inside the model; here the bucket is sampled per BATCH (same
distribution over buckets, zero padding waste, one jit program per bucket).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# data_transforms.py:23-24 — caffe-style means over 255, std restores 0-255 scale.
EGO4D_BASELINE_MEAN = np.array([103.53, 116.28, 123.675]) / 255.0
EGO4D_BASELINE_STD = np.array([1.0, 1.0, 1.0]) / 255.0
IMNET_MEAN = np.array([0.485, 0.456, 0.406])
IMNET_STD = np.array([0.229, 0.224, 0.225])
EGO4D_MEAN = np.array([0.4054, 0.3713, 0.3364])
EGO4D_STD = np.array([0.2400, 0.2237, 0.2219])

NORM_TABLE = {
    "ego4d_baseline": (EGO4D_BASELINE_MEAN, EGO4D_BASELINE_STD),
    "imagenet": (IMNET_MEAN, IMNET_STD),
    "own": (EGO4D_MEAN, EGO4D_STD),
}


@dataclass(frozen=True)
class AugConfig:
    resize_spec: tuple = ((544, 640, 704, 768), (640, 758, 896, 1024))  # (hs, ws)
    crop_spec: tuple | None = (0.9, 0.9)
    flip: bool = True
    channel_order: str = "BGR"
    brightness: float = 0.15
    contrast: float = 0.1
    saturation: float = 0.0
    hue: float = 0.05
    normalization: str = "ego4d_baseline"

    @property
    def buckets(self) -> list[tuple[int, int]]:
        hs, ws = self.resize_spec
        if isinstance(hs, (list, tuple)):
            return list(zip(hs, ws))
        return [(int(hs), int(ws))]

    def eval_bucket(self) -> tuple[int, int]:
        # "testing uses the largest scale" (wrapper_utils.py:66-69).
        return self.buckets[-1]


def random_crop_relative(rng: np.random.Generator, img, boxes, crop_spec):
    """detectron2 RandomCrop("relative_range", (ch, cw)): crop fraction drawn
    uniformly in [spec, 1], random location; boxes translated."""
    h, w = img.shape[:2]
    spec = np.asarray(crop_spec, dtype=np.float64)
    frac = spec + rng.random(2) * (1.0 - spec)
    ch, cw = int(h * frac[0] + 0.5), int(w * frac[1] + 0.5)
    y0 = rng.integers(0, h - ch + 1)
    x0 = rng.integers(0, w - cw + 1)
    img = img[y0 : y0 + ch, x0 : x0 + cw]
    boxes = boxes - np.array([x0, y0, x0, y0], dtype=boxes.dtype)
    boxes = np.stack(
        [
            np.clip(boxes[:, 0], 0, cw),
            np.clip(boxes[:, 1], 0, ch),
            np.clip(boxes[:, 2], 0, cw),
            np.clip(boxes[:, 3], 0, ch),
        ],
        axis=1,
    )
    return img, boxes


def horizontal_flip(img, boxes):
    w = img.shape[1]
    img = img[:, ::-1]
    flipped = boxes.copy()
    flipped[:, 0] = w - boxes[:, 2]
    flipped[:, 2] = w - boxes[:, 0]
    return np.ascontiguousarray(img), flipped


def channel_permute(img, original="RGB", new="BGR"):
    if original == new or img.shape[-1] != 3:
        return img
    order = [original.index(c) for c in new]
    return img[..., order]


def _blend(a, b, alpha):
    return np.clip(alpha * a + (1.0 - alpha) * b, 0.0, 1.0)


def color_jitter(rng: np.random.Generator, img01: np.ndarray, brightness, contrast, saturation, hue):
    """torchvision ColorJitter semantics: random order of the four ops, each
    factor uniform in its range; operates on the float [0,1] image."""
    ops = []
    if brightness:
        f = rng.uniform(max(0.0, 1 - brightness), 1 + brightness)
        ops.append(("b", f))
    if contrast:
        f = rng.uniform(max(0.0, 1 - contrast), 1 + contrast)
        ops.append(("c", f))
    if saturation:
        f = rng.uniform(max(0.0, 1 - saturation), 1 + saturation)
        ops.append(("s", f))
    if hue:
        f = rng.uniform(-hue, hue)
        ops.append(("h", f))
    rng.shuffle(ops)

    for kind, f in ops:
        if kind == "b":
            img01 = np.clip(img01 * f, 0, 1)
        elif kind == "c":
            gray = (0.299 * img01[..., 0] + 0.587 * img01[..., 1] + 0.114 * img01[..., 2]).mean()
            img01 = _blend(img01, gray, f)
        elif kind == "s":
            gray = (0.299 * img01[..., 0] + 0.587 * img01[..., 1] + 0.114 * img01[..., 2])[..., None]
            img01 = _blend(img01, gray, f)
        elif kind == "h":
            import cv2

            hsv = cv2.cvtColor((img01 * 255).astype(np.uint8), cv2.COLOR_RGB2HSV)
            hsv[..., 0] = (hsv[..., 0].astype(np.int32) + int(f * 180)) % 180
            img01 = cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB).astype(np.float32) / 255.0
    return img01


_NORM_F32 = {}


def _norm_scale_bias(normalization: str):
    """(1/std, -mean/std) as f32 — a float64 mean/std broadcast would upcast
    the whole frame to f64 (measured 71 of 132 ms/item at 1080p eval)."""
    if normalization not in _NORM_F32:
        mean, std = NORM_TABLE[normalization]
        _NORM_F32[normalization] = (
            (1.0 / std).astype(np.float32), (-mean / std).astype(np.float32))
    return _NORM_F32[normalization]


def normalize(img01: np.ndarray, normalization: str) -> np.ndarray:
    scale, bias = _norm_scale_bias(normalization)
    return img01.astype(np.float32, copy=False) * scale + bias


def resize_with_boxes(img: np.ndarray, boxes: np.ndarray, target_hw: tuple[int, int]):
    """Exact-size bilinear resize (aspect not preserved) + torchvision
    resize_boxes scaling — the NoNormTransform multiscale semantics."""
    import cv2

    h, w = img.shape[:2]
    th, tw = target_hw
    out = cv2.resize(img, (tw, th), interpolation=cv2.INTER_LINEAR)
    sy, sx = th / h, tw / w
    boxes = boxes * np.array([sx, sy, sx, sy], dtype=np.float64)
    return out, boxes.astype(np.float32)


def transform_example(
    rng: np.random.Generator,
    img: np.ndarray,
    boxes: np.ndarray,
    cfg: AugConfig,
    bucket: tuple[int, int],
    training: bool,
):
    """Full per-example chain. img uint8 RGB HWC -> normalized f32 HWC at the
    bucket size; boxes follow every geometric op."""
    boxes = np.asarray(boxes, dtype=np.float64).reshape(-1, 4)
    if training:
        if cfg.crop_spec and tuple(cfg.crop_spec) != (1, 1):
            img, boxes = random_crop_relative(rng, img, boxes, cfg.crop_spec)
        if cfg.flip and rng.random() < 0.5:
            img, boxes = horizontal_flip(img, boxes)
    img = channel_permute(img, "RGB", cfg.channel_order)
    if training:
        img01 = img.astype(np.float32) / 255.0
        img01 = color_jitter(rng, img01, cfg.brightness, cfg.contrast, cfg.saturation, cfg.hue)
        img01 = normalize(img01, cfg.normalization)
    else:
        # Fused u8 -> normalized f32 (one pass instead of /255 then affine).
        scale, bias = _norm_scale_bias(cfg.normalization)
        img01 = img.astype(np.float32) * (scale / 255.0) + bias
    img01, boxes = resize_with_boxes(img01, boxes, bucket)
    return img01, boxes.astype(np.float32)
