"""Faster R-CNN assembly with the reference's three-phase seam (port of
``transfusion_tpu/models/detector.py``): ``forward_features`` (backbone
body), ``apply_fpn`` and ``apply_rpn_roi``, so the fusion can rewrite
backbone maps before the FPN. With ``train=True`` the RPN keeps its training
proposal counts and targets are assigned: anchor labels for the RPN loss and
sampled RoIs with triple labels and regression targets for the heads; the
module's training mode turns dropout on, as ``deterministic=False`` does in
JAX. Postprocessing is the separate function :func:`detections_from_outputs`.

Top-level names are the reference checkpoint's: ``backbone.body``,
``backbone.fpn``, ``rpn.head``, ``roi_heads``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
from torch import nn

from transfusion_torch.device import resolve_device
from transfusion_torch.models.fpn import FPN
from transfusion_torch.models.resnet import RESNET50_CHANNELS, ResNet
from transfusion_torch.models.roi_heads import (RoIConfig, RoIHeads, postprocess_detections,
                                                select_training_samples)
from transfusion_torch.models.rpn import (RPNConfig, RPNHead, assign_targets_to_anchors,
                                          generate_proposals)
from transfusion_torch.models.text_encoder import dropout
from transfusion_torch.ops.matcher import uniform_draws
from transfusion_torch.ops.roi_align import multiscale_roi_align

POOLED = 7


@dataclass(frozen=True)
class DetectorConfig:
    roi: RoIConfig = field(default_factory=RoIConfig)
    rpn: RPNConfig = field(default_factory=RPNConfig)
    fpn_out_channels: int = 256
    stride_in_1x1: bool = True  # adapt_to_detectron
    stage_sizes: tuple = (3, 4, 6, 3)
    s2d_stem: bool = False
    # Frozen-prefix tape cut (units [stem, layer1..layer4]); the flagship
    # trains with 5: the body never unfreezes.
    stop_grad_stages: int = 0
    dtype: torch.dtype = torch.float32


class _Backbone(nn.Module):
    def __init__(self, cfg: DetectorConfig):
        super().__init__()
        self.body = ResNet(cfg.stage_sizes, cfg.stride_in_1x1, cfg.dtype, cfg.stop_grad_stages)
        chans = [RESNET50_CHANNELS[str(i)] for i in range(len(cfg.stage_sizes))]
        self.fpn = FPN(chans, cfg.fpn_out_channels, cfg.dtype)


class _RPN(nn.Module):
    def __init__(self, cfg: DetectorConfig):
        super().__init__()
        self.head = RPNHead(cfg.fpn_out_channels, len(cfg.rpn.aspect_ratios), cfg.dtype)


class FasterRCNN(nn.Module):
    """Entry point: built on ``device`` (``cuda`` unless named)."""

    def __init__(self, cfg: DetectorConfig, device=None):
        super().__init__()
        dev = resolve_device(device)
        if cfg.s2d_stem:
            raise NotImplementedError("the port has the plain 7x7 stem only (s2d_stem=False)")
        self.cfg = cfg
        self.backbone = _Backbone(cfg)
        self.rpn = _RPN(cfg)
        self.roi_heads = RoIHeads(cfg.roi, cfg.fpn_out_channels * POOLED * POOLED, cfg.dtype)
        self.to(dev).eval()

    @property
    def device(self) -> torch.device:
        return self.backbone.body.conv1.weight.device

    def forward_features(self, images):
        """images [B, H, W, 3] (the JAX batch layout) -> backbone maps
        {"0".."3"}, NCHW in the channels-last memory format."""
        x = images.to(self.device).permute(0, 3, 1, 2)
        return self.backbone.body(x)

    def apply_fpn(self, feats):
        return self.backbone.fpn(feats)

    def propose(self, fpn_feats, image_hw, train: bool = False):
        """RPN head and proposals over FPN maps, at the training proposal
        counts when ``train``."""
        objectness, deltas = self.rpn.head(fpn_feats)
        return generate_proposals(objectness, deltas, image_hw, self.cfg.rpn, train)

    def apply_roi(self, fpn_feats, rpn_out, image_hw, targets=None, sample: bool = False,
                  draws=None, generator=None, rng=None):
        """RoI heads over ``propose``'s proposals. Without ``sample``: every
        proposal. With it: targets {boxes [B, G, 4], nouns, verbs, ttcs,
        valid [B, G]} are assigned and S RoIs an image sampled with
        ``draws`` (positive and negative uniform keys [B, P + G]), drawn from
        ``generator`` when not given, so validation losses can sample on an
        eval forward; ``rng`` (a DropoutRNG) feeds the RoI dropouts in
        training mode. Returns {"roi_outputs", "proposals", "image_sizes"};
        when sampling roi_outputs also carries labels (nouns, verbs, ttcs)
        and reg_targets, and proposals (a copy of ``rpn_out``) the anchor
        labels and matches."""
        sampled = None
        if sample:
            dev = self.device
            targets = {k: v.to(dev) for k, v in targets.items()}
            rpn_out = dict(rpn_out)
            rpn_out["labels"], rpn_out["matches"] = assign_targets_to_anchors(
                rpn_out["anchors"], targets["boxes"].float(), targets["valid"].bool(), self.cfg.rpn)
            if draws is None:
                n = rpn_out["boxes"].shape[1] + targets["boxes"].shape[1]
                draws = uniform_draws((rpn_out["boxes"].shape[0], n), generator, dev)
            sampled = select_training_samples(rpn_out["boxes"], rpn_out["valid"], targets,
                                              self.cfg.roi, draws)
            rois, roi_valid = sampled["rois"], sampled["valid"]
        else:
            rois, roi_valid = rpn_out["boxes"], rpn_out["valid"]
        levels = {k: v.permute(0, 2, 3, 1) for k, v in fpn_feats.items() if k.isdigit()}
        pooled = multiscale_roi_align(levels, rois, image_hw)
        pooled = dropout(pooled, self.cfg.roi.box_1_dropout, self.training, rng)
        roi_outputs = {**self.roi_heads(pooled, rng), "proposals": rois, "proposals_valid": roi_valid}
        if sampled is not None:
            roi_outputs["labels"] = (sampled["nouns"], sampled["verbs"], sampled["ttcs"])
            roi_outputs["reg_targets"] = sampled["reg_targets"]
        return {"roi_outputs": roi_outputs, "proposals": rpn_out, "image_sizes": tuple(image_hw)}

    def apply_rpn_roi(self, fpn_feats, image_hw, targets=None, train: bool = False,
                      draws=None, generator=None, rng=None, sample: bool | None = None):
        """``propose`` then ``apply_roi`` over FPN maps: in training at the
        training proposal counts. ``sample`` (default: ``train``) assigns
        targets and samples RoIs, also on an eval forward."""
        rpn_out = self.propose(fpn_feats, image_hw, train)
        return self.apply_roi(fpn_feats, rpn_out, image_hw, targets, train if sample is None else sample,
                              draws, generator, rng)

    def forward(self, images, image_hw, targets=None, train: bool = False, draws=None,
                generator=None, rng=None):
        return self.apply_rpn_roi(self.apply_fpn(self.forward_features(images)), image_hw,
                                  targets, train, draws, generator, rng)


def detections_from_outputs(outputs: dict, cfg: DetectorConfig, noun_verb_frequencies=None,
                            training: bool = False):
    """Postprocess raw RoI outputs into per-image top-k detections (eval, or
    the training second pass of the transformer TTC head)."""
    roi = outputs["roi_outputs"]
    return postprocess_detections(roi, roi["proposals"], roi["proposals_valid"],
                                  outputs["image_sizes"], cfg.roi,
                                  noun_verb_frequencies=noun_verb_frequencies, training=training)


def rescale_boxes(boxes, from_hw, to_hw):
    """torchvision resize_boxes: independent x/y ratios; from_hw/to_hw are
    (h, w) pairs or [B, 2] tensors."""
    from_hw = torch.as_tensor(from_hw, dtype=boxes.dtype, device=boxes.device)
    to_hw = torch.as_tensor(to_hw, dtype=boxes.dtype, device=boxes.device)
    if from_hw.dim() == 1:
        from_hw = from_hw[None]
    if to_hw.dim() == 1:
        to_hw = to_hw[None]
    ry = (to_hw[:, 0] / from_hw[:, 0])[:, None]
    rx = (to_hw[:, 1] / from_hw[:, 1])[:, None]
    return torch.stack([boxes[..., 0] * rx, boxes[..., 1] * ry,
                        boxes[..., 2] * rx, boxes[..., 3] * ry], dim=-1)
