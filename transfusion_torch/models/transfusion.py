"""The TransFusion model: Faster R-CNN + narration encoder + per-level
fusion (port of ``transfusion_tpu/models/transfusion.py``: the
``cross_transformer`` fusion with the ``sbert`` text encoder in ``tokens``
mode and no LM head, the flagship's path, for eval and training).

``TransFusion`` subclasses :class:`FasterRCNN` so its state dict has the
reference's flat names (``backbone.*``, ``rpn.*``, ``roi_heads.*``,
``patches_to_token.i``, ``tokens_to_features.i``,
``cross_fusion_encoders.i``, ``narr_pooling_layer.*``). ``forward`` takes
the JAX batch contract: ``image [B, H, W, 3]``, ``input_ids``,
``attention_mask``, ``image_hw`` and, to train, ``targets``. As in JAX,
``forward(batch, train=True)`` assigns targets and samples RoIs; dropout
follows the module's ``.train()`` / ``.eval()`` mode and draws from the
``rng`` (a ``text_encoder.DropoutRNG``) the train step passes.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
from torch import nn

from transfusion_torch.device import resolve_device
from transfusion_torch.models.detector import DetectorConfig, FasterRCNN
from transfusion_torch.models.fusion import CrossFusionLevel, RegroupPatches
from transfusion_torch.models.resnet import RESNET50_CHANNELS
from transfusion_torch.models.roi_heads import RoIConfig
from transfusion_torch.models.rpn import RPNConfig
from transfusion_torch.models.text_encoder import BertConfig, NarrationEncoder


@dataclass(frozen=True)
class FusionConfig:
    fusion_type: str = "cross_transformer"
    fpn_features: tuple = (0, 1, 2, 3)
    patch_h: tuple = (4, 4, 2, 1)
    patch_w: tuple = (4, 4, 2, 1)
    num_layers: tuple = (4, 4, 4, 4)
    token_dim: int = 896
    num_heads: int = 4
    ff_multiplier: float = 2.0
    vis_mask_type: str = "global"
    use_flash_attention: bool = False
    token_dropout: float = 0.15
    patch_dropout: float = 0.1
    backproj_dropout: float = 0.1


@dataclass(frozen=True)
class TransFusionConfig:
    detector: DetectorConfig = field(default_factory=DetectorConfig)
    fusion: FusionConfig = field(default_factory=FusionConfig)
    bert: BertConfig = field(default_factory=BertConfig.minilm_l12)
    text_encoder: str = "sbert"
    narr_out_mode: str = "tokens"
    out_mlp: int | None = 896
    out_dropout: float = 0.1
    lm_on: bool = False
    dtype: torch.dtype = torch.float32


def flagship_config() -> TransFusionConfig:
    """The v2 flagship (ego_nao_res50_ego4dv2 + ego_vis_det_ego4dv2 dims):
    bf16 compute with f32 params, the plain 7x7 stem, and attention kernel K2
    on at its gate. Mirrors ``__graft_entry__.py::_flagship_config``."""
    dt = torch.bfloat16
    return TransFusionConfig(
        detector=DetectorConfig(
            roi=RoIConfig(num_nouns=88, num_verbs=75, representation_size=1280,
                          score_thresh=0.01, additional_postprocessing=True),
            rpn=RPNConfig(score_thresh=0.01),
            s2d_stem=False,
            stop_grad_stages=5,
            dtype=dt,
        ),
        fusion=FusionConfig(use_flash_attention=True),
        bert=BertConfig.minilm_l12(),
        out_mlp=896,
        dtype=dt,
    )


class TransFusion(FasterRCNN):
    """Entry point: built on ``device`` (``cuda`` unless named; raises when
    CUDA is missing). Weights start as PyTorch's default init: load a state
    dict or use ``weights.init_random_``."""

    def __init__(self, cfg: TransFusionConfig, device=None):
        dev = resolve_device(device)
        if cfg.fusion.fusion_type != "cross_transformer":
            raise NotImplementedError(f"fusion_type {cfg.fusion.fusion_type!r} is not ported yet")
        if cfg.text_encoder != "sbert" or cfg.narr_out_mode != "tokens":
            raise NotImplementedError("only the sbert text encoder in tokens mode is ported")
        if cfg.lm_on:
            raise NotImplementedError("the LM auxiliary head is not ported yet")
        super().__init__(cfg.detector, device=dev)
        self.tcfg = cfg
        f, dt = cfg.fusion, cfg.dtype
        self.narr_pooling_layer = NarrationEncoder(cfg.bert, cfg.out_mlp, dt, cfg.out_dropout)
        token_dim = f.token_dim
        self.patches_to_token = nn.ModuleList()
        self.tokens_to_features = nn.ModuleList()
        self.cross_fusion_encoders = nn.ModuleList()
        for i, lvl in enumerate(f.fpn_features):
            c = RESNET50_CHANNELS[str(lvl)]
            ph, pw = f.patch_h[i], f.patch_w[i]
            self.patches_to_token.append(nn.Conv2d(c, token_dim, (ph, pw), stride=(ph, pw), bias=False))
            self.tokens_to_features.append(RegroupPatches(token_dim, c, ph, pw))
            self.cross_fusion_encoders.append(CrossFusionLevel(
                token_dim, f.num_layers[i], f.num_heads, f.ff_multiplier, (ph, pw),
                f.vis_mask_type, f.use_flash_attention, dt, f.token_dropout, f.patch_dropout,
                f.backproj_dropout,
            ))
        self.to(dev).eval()

    def trunk(self, batch: dict, rng=None):
        """Backbone -> per-level language fusion (each fused map replaces its
        backbone map; every level sees the encoder's language tokens) -> FPN."""
        feats = self.forward_features(batch["image"])
        dev = self.device
        lang, lang_mask = self.narr_pooling_layer(batch["input_ids"].to(dev),
                                                  batch["attention_mask"].to(dev), rng)
        for i, lvl in enumerate(self.tcfg.fusion.fpn_features):
            key = str(lvl)
            feats[key] = self.cross_fusion_encoders[i](
                feats[key], lang, lang_mask, self.patches_to_token[i], self.tokens_to_features[i], rng)
        return self.apply_fpn(feats)

    def forward(self, batch: dict, train: bool = False, draws=None, generator=None, rng=None):
        """Returns {"roi_outputs", "proposals", "image_sizes"} (see
        ``FasterRCNN.apply_rpn_roi`` for ``train``, ``draws``, ``generator``
        and ``rng``)."""
        return self.apply_rpn_roi(self.trunk(batch, rng), batch["image_hw"], batch.get("targets"),
                                  train, draws, generator, rng)
