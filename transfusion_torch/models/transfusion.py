"""The TransFusion model: Faster R-CNN + narration encoder + per-level
fusion (port of ``transfusion_tpu/models/transfusion.py``: the
``cross_transformer`` fusion with the ``sbert`` text encoder in ``tokens``
mode and no LM head, the flagship's path, for eval, validation with losses
and training), and ``build_transfusion_config`` from a derived run config.

``TransFusion`` subclasses :class:`FasterRCNN` so its state dict has the
reference's flat names (``backbone.*``, ``rpn.*``, ``roi_heads.*``,
``patches_to_token.i``, ``tokens_to_features.i``,
``cross_fusion_encoders.i``, ``narr_pooling_layer.*``). ``forward`` takes
the JAX batch contract: ``image [B, H, W, 3]``, ``input_ids``,
``attention_mask``, ``image_hw`` and, to train, ``targets``. As in JAX,
``forward(batch, train=True)`` assigns targets and samples RoIs; dropout
follows the module's ``.train()`` / ``.eval()`` mode and draws from the
``rng`` (a ``text_encoder.DropoutRNG``) the train step passes.
``eval_with_losses`` runs the trunk once and two RoI branches on it: every
proposal for the detections, and sampled RoIs for the validation losses.
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
from transfusion_torch.ops.attention import BF16_HEAD_DIMS


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


def build_transfusion_config(config: dict, num_nouns: int, num_verbs: int,
                             dtype=torch.float32) -> TransFusionConfig:
    """Map a derived reference-format config dict (see ``config.derive``)
    onto TransFusionConfig, as ``transfusion_tpu/models/transfusion.py:468``
    does, for the options the port builds: a ResNet-50 family trunk with
    frozen BN and the plain stem, the ``cross_transformer`` fusion with
    sin1d positions, LayerNorm, GELU, replaced FPN maps and no language
    forwarding, the sbert/MiniLM text tower in tokens mode, and the linear
    TTC head. Every other option raises NotImplementedError naming it.
    Flash attention is on unless the fusion args turn it off, as in JAX."""
    run, model = config["run"], config["model"]
    rcnn_kwargs = model.get("rcnn_kwargs", {})
    narr = run["narration_embeds"]
    narr_args = narr["args"]
    fusion_cfg = run["narr_fusion"]
    fargs = fusion_cfg.get("args", {})
    criterion = run["criterion"]
    bn = model.get("batch_norm") or {}
    text_pooling = narr_args.get("text_pooling", "sbert_finetune")
    model_v = narr_args.get("model_v", "all-MiniLM-L12-v2")
    unported = [
        ("model.type", model.get("type", "res50"), "res50"),
        ("model.batch_norm.use", bool(bn.get("use", False)), False),
        ("model.s2d_stem", bool(model.get("s2d_stem", False)), False),
        ("model.ttc_hand_head.use",
         bool(criterion.get("ttc", 0) and (model.get("ttc_hand_head") or {}).get("use")), False),
        ("run.criterion.lm", bool(criterion.get("lm", 0)), False),
        ("run.narration_embeds.use", bool(narr.get("use", True)), True),
        ("run.narration_embeds.res50_f / slowfast_f_v",
         bool(narr.get("res50_f", False) or narr.get("slowfast_f_v", False)), False),
        ("narration_embeds.args.pooling", narr_args.get("pooling") == "sbert", False),
        ("narration_embeds.args.text_pooling", text_pooling, "sbert_finetune"),
        ("narration_embeds.args.model_v",
         model_v.startswith(("t5-", "flan-t5-")) or model_v == "distilgpt2", False),
        ("narration_embeds.args.out_tanh", bool(narr_args.get("out_tanh", False)), False),
        ("narration_embeds.args.type_embeddings", tuple(narr_args.get("type_embeddings") or ()), ()),
        ("narr_fusion.type", fusion_cfg.get("type", "cross_transformer"), "cross_transformer"),
        ("narr_fusion.narr_out_mode", fusion_cfg.get("narr_out_mode", "tokens"), "tokens"),
        ("narr_fusion.share_encoders", bool(fusion_cfg.get("share_encoders", False)), False),
        ("narr_fusion.pos_embedding", fusion_cfg.get("pos_embedding", "sin1d"), "sin1d"),
        ("narr_fusion.forward_language_f", fusion_cfg.get("forward_language_f", False), False),
        ("narr_fusion.replace_fpn_features", fusion_cfg.get("replace_fpn_features", True), True),
        ("narr_fusion.args.final_norm", fargs.get("final_norm", "ln"), "ln"),
        ("narr_fusion.args.activ_f", fargs.get("activ_f", "gelu"), "gelu"),
    ]
    for option, value, supported in unported:
        if value != supported:
            raise NotImplementedError(f"{option}={value!r} is not ported yet")
    bert = BertConfig.minilm_l12()
    if model_v == "minilm-tiny":
        bert = BertConfig(hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128)
    elif "L6" in model_v:
        bert = BertConfig(num_layers=6)
    roi = RoIConfig(
        num_nouns=num_nouns,
        num_verbs=num_verbs,
        representation_size=model["representation_size"],
        batch_size_per_image=rcnn_kwargs.get("box_batch_size_per_image", 512),
        score_thresh=rcnn_kwargs.get("box_score_thresh", 0.05),
        box_1_dropout=model.get("box_1_dropout", 0.0),
        box_2_dropout=model.get("box_2_dropout", 0.0),
        classif_dropout=run.get("class_dropout", 0.0),
        ttc_on=bool(criterion.get("ttc", 0)),
        additional_postprocessing=model.get("additional_postprocessing", False),
    )
    det = DetectorConfig(
        roi=roi,
        rpn=RPNConfig(score_thresh=rcnn_kwargs.get("rpn_score_thresh", 0.0)),
        stride_in_1x1=model.get("adapt_to_detectron", False),
        stage_sizes=tuple(model.get("stage_sizes", (3, 4, 6, 3))),
        dtype=dtype,
    )
    fus = FusionConfig(
        fpn_features=tuple(fusion_cfg.get("fpn_features", (0, 1, 2, 3))),
        patch_h=tuple(fusion_cfg.get("patch_h", (4, 4, 2, 1))),
        patch_w=tuple(fusion_cfg.get("patch_w", (4, 4, 2, 1))),
        num_layers=tuple(fargs.get("num_layers", (4, 4, 4, 4))),
        token_dim=fargs.get("input_f_size", 896),
        num_heads=fargs.get("num_heads", 4),
        ff_multiplier=fargs.get("fforward_multiplier", 2),
        token_dropout=fargs.get("token_dropout", 0.1),
        patch_dropout=fargs.get("patch_dropout", 0.1),
        backproj_dropout=fusion_cfg.get("backproj_dropout", 0.1),
        vis_mask_type=fusion_cfg.get("vis_mask_type", "global"),
        use_flash_attention=bool(fargs.get("use_flash_attention", True)),
    )
    return TransFusionConfig(detector=det, fusion=fus, bert=bert,
                             out_mlp=narr_args.get("out_mlp"),
                             out_dropout=narr_args.get("out_dropout", 0.1), dtype=dtype)


def check_attention_head_dim(cfg: TransFusionConfig, device) -> None:
    """On CUDA, the fusion's attention kernels (K2-K4) are compiled for bf16
    head dims ``BF16_HEAD_DIMS`` and f32 head dims up to 256: a model whose
    head dim they do not take fails here, when it is built, not in a step."""
    f = cfg.fusion
    if torch.device(device).type != "cuda" or not f.use_flash_attention:
        return
    d = f.token_dim // f.num_heads
    ok = d in BF16_HEAD_DIMS if cfg.dtype == torch.bfloat16 else d <= 256
    if not ok:
        raise ValueError(f"fusion head dim {f.token_dim} / {f.num_heads} = {d} is not one the "
                         f"{cfg.dtype} attention kernels take (bf16 {BF16_HEAD_DIMS}, f32 <= 256); "
                         "set narr_fusion.args.use_flash_attention: False")


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
        check_attention_head_dim(cfg, dev)
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

    def eval_with_losses(self, batch: dict, draws=None, generator=None):
        """One eval forward giving {"eval": every proposal's RoI outputs, for
        the detections; "loss": the same trunk's RPN labels and sampled RoIs
        (``draws`` / ``generator`` as in ``apply_roi``), for the
        validation losses}. Both branches take one set of eval proposals.
        Dropout stays off (eval mode)."""
        fpn_feats = self.trunk(batch)
        hw = batch["image_hw"]
        rpn_out = self.propose(fpn_feats, hw)
        return {"eval": self.apply_roi(fpn_feats, rpn_out, hw),
                "loss": self.apply_roi(fpn_feats, rpn_out, hw, batch["targets"], True, draws, generator)}
