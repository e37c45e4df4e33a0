"""Detection ops of the port: the JAX package's ``transfusion_tpu.ops``
exports, from the modules of the same names."""

from transfusion_torch.ops.boxes import BoxCoder, box_area, box_iou, clip_boxes, small_box_mask
from transfusion_torch.ops.matcher import (
    BELOW_LOW_THRESHOLD,
    BETWEEN_THRESHOLDS,
    balanced_sample,
    balanced_sample_idx,
    match_proposals,
)
from transfusion_torch.ops.nms import batched_nms, nms

__all__ = [
    "BoxCoder",
    "box_area",
    "box_iou",
    "clip_boxes",
    "small_box_mask",
    "nms",
    "batched_nms",
    "match_proposals",
    "balanced_sample",
    "balanced_sample_idx",
    "BELOW_LOW_THRESHOLD",
    "BETWEEN_THRESHOLDS",
]
