"""Static-slot exact greedy NMS over a batch of images (port of
``transfusion_tpu/ops/nms.py``).

Candidates are sorted by score (descending, stable: equal scores keep input
order, as ``jnp.argsort(-s, stable=True)`` does). Score-sorted blocks are
suppressed against the boxes already kept with one batched IoU sweep, then
the within-block dependencies are resolved by Jacobi iteration of the
strictly lower-triangular suppression recurrence, which converges to the
unique greedy answer. The block loop stops once every image has
``max_keep`` boxes. Outputs keep the JAX contract: ``keep_idx [B, max_keep]``
indices into the input order (0 in empty slots) and ``keep_valid``.
"""

from __future__ import annotations

import torch

from transfusion_torch.ops.boxes import box_iou


def _resolve_block(overlap, alive0):
    """Fixpoint of alive[i] = alive0[i] & ~any_j<i(overlap[i, j] & alive[j])."""
    alive = alive0
    for _ in range(overlap.shape[-1]):
        new = alive0 & ~torch.any(overlap & alive[:, None, :], dim=-1)
        if torch.equal(new, alive):
            break
        alive = new
    return alive


def nms_multi(boxes, scores, valid, iou_thresh: float, max_keep: int, block_size: int = 256):
    """boxes [B, N, 4], scores [B, N], valid [B, N] bool -> (keep_idx, keep_valid)."""
    bsz, n = scores.shape
    dev = scores.device
    scores = torch.where(valid, scores, torch.full_like(scores, float("-inf")))
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    sboxes = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    svalid = torch.gather(valid, 1, order)

    pad = (-n) % block_size
    if pad:
        sboxes = torch.nn.functional.pad(sboxes, (0, 0, 0, pad))
        svalid = torch.nn.functional.pad(svalid, (0, pad), value=False)
    n_pad = n + pad
    idx = torch.arange(n_pad, device=dev)
    blk = torch.arange(block_size, device=dev)
    lower = (blk[None, :] < blk[:, None])[None]

    keep = torch.zeros((bsz, n_pad), dtype=torch.bool, device=dev)
    counts = torch.zeros((bsz,), dtype=torch.int64, device=dev)
    for s in range(0, n_pad, block_size):
        if not bool((counts < max_keep).any()):
            break
        blk_boxes = sboxes[:, s : s + block_size]
        iou_all = box_iou(blk_boxes, sboxes)  # [B, blk, n_pad]
        prior_kept = keep & (idx < s)[None, :]
        suppressed = torch.any((iou_all > iou_thresh) & prior_kept[:, None, :], dim=-1)
        overlap = (iou_all[:, :, s : s + block_size] > iou_thresh) & lower
        alive = _resolve_block(overlap, svalid[:, s : s + block_size] & ~suppressed)
        keep[:, s : s + block_size] = alive
        counts = counts + alive.sum(-1)

    # First max_keep kept positions per image, already in score order.
    key = torch.where(keep, idx[None], n_pad + idx[None])
    pos = torch.sort(key, dim=-1, stable=True).indices[:, :max_keep]
    keep_valid = torch.gather(keep, 1, pos)
    orig = torch.gather(order, 1, torch.clamp(pos, max=n - 1))
    keep_idx = torch.where(keep_valid, orig, torch.zeros_like(orig))
    return keep_idx, keep_valid


def class_nms_multi(boxes, scores, classes, valid, iou_thresh, max_keep, block_size=256):
    """Per-class NMS via the coordinate-offset trick; ``classes`` may hold
    noun labels (RoI postprocess) or FPN level ids (RPN filtering)."""
    masked = torch.where(valid[..., None], boxes, torch.zeros_like(boxes))
    max_coord = masked.amax(dim=(1, 2), keepdim=True)
    offsets = classes.to(boxes.dtype)[..., None] * (max_coord + 1.0)
    return nms_multi(boxes + offsets, scores, valid, iou_thresh, max_keep, block_size)


def batched_nms(boxes, scores, classes, valid, iou_thresh, max_keep, block_size=256):
    """Single-image per-class NMS (torchvision batched_nms semantics)."""
    idx, keep_valid = class_nms_multi(
        boxes[None], scores[None], classes[None], valid[None], iou_thresh, max_keep, block_size
    )
    return idx[0], keep_valid[0]
