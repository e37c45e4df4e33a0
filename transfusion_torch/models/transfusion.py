"""The TransFusion model: Faster R-CNN + narration encoder + per-level
fusion + the LM auxiliary head (port of
``transfusion_tpu/models/transfusion.py``: the ``cross_transformer``,
``asymmetric`` and ``space_time`` fusion families, the encoder stack shared
across levels, clip-feature early fusion, every positional kind, language
forwarding across levels, the sbert text encoder in tokens or embedding
mode, and the LM head, for eval, validation with losses and training), and
``build_transfusion_config`` from a derived run config.

``TransFusion`` subclasses :class:`FasterRCNN` so its state dict has the
reference's flat names (``backbone.*``, ``rpn.*``, ``roi_heads.*``,
``patches_to_token.i``, ``tokens_to_features.i``,
``cross_fusion_encoders.i``, ``narr_pooling_layer.*``, ``lm_layer.*``), and,
where JAX's tree has no reference name, names after JAX's modules
(``shared_t_encoder.layers.j`` for ``shared_layer_j``, ``vis_fusion.i`` for
``vis_fusion_<lvl>``, ``lm_layers.i`` for ``lm_layer_i``). ``forward`` takes
the JAX batch contract: ``image [B, H, W, 3]``, ``input_ids``,
``attention_mask``, ``image_hw``, ``visual_features [B, T, F]`` for the
clip-feature fusion and, to train, ``targets``. As in JAX,
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
from transfusion_torch.models.fusion import (
    CrossFusionLevel, EncoderLayer, PoolPredictor, RegroupPatches, _TEncoder)
from transfusion_torch.models.fusion_variants import (
    AsymmetricCrossFusionLevel, SpaceTimeFusionLevel, VisualFeatureFusion)
from transfusion_torch.models.resnet import RESNET50_CHANNELS
from transfusion_torch.models.roi_heads import RoIConfig
from transfusion_torch.models.rpn import RPNConfig
from transfusion_torch.models.text_encoder import BertConfig, NarrationEncoder
from transfusion_torch.ops.attention import BF16_HEAD_DIMS

FUSION_TYPES = ("cross_transformer", "space_time", "asymmetric")
# The clip features' width (VisLangFusionBoxWrapper): SlowFast 2304, ResNet-50 2048.
CLIP_FEATURE_DIMS = {"slowfast_f_v": 2304, "res50_f": 2048}


@dataclass(frozen=True)
class FusionConfig:
    # The fusion YAML's type: key (get_cross_box_encoder dispatch).
    fusion_type: str = "cross_transformer"
    fpn_features: tuple = (0, 1, 2, 3)
    patch_h: tuple = (4, 4, 2, 1)
    patch_w: tuple = (4, 4, 2, 1)
    num_layers: tuple = (4, 4, 4, 4)
    token_dim: int = 896
    num_heads: int = 4
    ff_multiplier: float = 2.0
    token_dropout: float = 0.15
    patch_dropout: float = 0.1
    backproj_dropout: float = 0.1
    pos_embedding: str = "sin1d"  # sin1d | sin2d | learned | zero
    final_norm: str = "ln"        # "ln", or none
    activation: str = "gelu"      # gelu, or relu for any other name
    vis_mask_type: str = "global"
    forward_language_f: object = False  # False | "direct" | "sum"
    replace_fpn_features: bool = True
    share_encoders: bool = False  # one stack of num_layers[0] layers for every level
    use_flash_attention: bool = False
    # The asymmetric family: language depth and the two streams' dropouts.
    asymm_lang_layers: int = 2
    asymm_vis_dropout: float = 0.1
    asymm_lang_dropout: float = 0.1


@dataclass(frozen=True)
class TransFusionConfig:
    detector: DetectorConfig = field(default_factory=DetectorConfig)
    fusion: FusionConfig = field(default_factory=FusionConfig)
    bert: BertConfig = field(default_factory=BertConfig.minilm_l12)
    text_encoder: str = "sbert"
    # "tokens" feeds per-token features to the fusion; "embedding" one pooled
    # sentence vector as a single fully attended language token.
    narr_out_mode: str = "tokens"
    out_mlp: int | None = 896
    out_dropout: float = 0.1
    lm_on: bool = False
    lm_pooling: str = "mean"
    lm_use_ln: bool = True
    # False: one head on the last level's fused language; True: one head
    # averaged over every level's; "sep": a head per level, averaged.
    lm_multi: object = False
    # Classify the language features the last level was given instead.
    lm_use_f: bool = False
    # Clip-feature early fusion: batch["visual_features"] [B, T, F] fuses
    # with each level's patch tokens before the language stage.
    use_visual_features: bool = False
    visual_feature_layers: int = 2
    # The clip flag that is on: it fixes F, which JAX's layer reads from the
    # batch and the port's needs at build (visual_feature_dim).
    clip_features: str = "slowfast_f_v"
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if self.clip_features not in CLIP_FEATURE_DIMS:
            raise ValueError(f"clip_features={self.clip_features!r}: one of {list(CLIP_FEATURE_DIMS)}")

    @property
    def visual_feature_dim(self) -> int:
        return CLIP_FEATURE_DIMS[self.clip_features]


def _mean_lm_outs(outs: list) -> dict:
    """Per-level LM logits averaged (MultiPoolPredictor[Sep])."""
    verb = outs[0]["verb_logits"]
    return {"noun_logits": sum(o["noun_logits"] for o in outs) / len(outs),
            "verb_logits": None if verb is None else sum(o["verb_logits"] for o in outs) / len(outs)}


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
        # The asymmetric dropouts default to token_dropout in the mapping.
        fusion=FusionConfig(use_flash_attention=True, asymm_vis_dropout=0.15,
                            asymm_lang_dropout=0.15),
        bert=BertConfig.minilm_l12(),
        out_mlp=896,
        dtype=dt,
    )


def build_transfusion_config(config: dict, num_nouns: int, num_verbs: int,
                             dtype=torch.float32) -> TransFusionConfig:
    """Map a derived reference-format config dict (see ``config.derive``)
    onto TransFusionConfig, as ``transfusion_tpu/models/transfusion.py:468``
    does, with its ValueErrors. The port builds a ResNet-50 family trunk with
    frozen BN and the plain stem, every fusion family and option, the
    sbert/MiniLM text tower in tokens or embedding mode, the LM head and the
    linear TTC head. Every other option raises NotImplementedError naming
    it. Flash attention is on unless the fusion args turn it off, as in JAX."""
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
        ("run.narration_embeds.use", bool(narr.get("use", True)), True),
        ("narration_embeds.args.pooling", narr_args.get("pooling") == "sbert", False),
        ("narration_embeds.args.text_pooling", text_pooling, "sbert_finetune"),
        ("narration_embeds.args.model_v",
         model_v.startswith(("t5-", "flan-t5-")) or model_v == "distilgpt2", False),
        ("narration_embeds.args.out_tanh", bool(narr_args.get("out_tanh", False)), False),
        ("narration_embeds.args.type_embeddings", tuple(narr_args.get("type_embeddings") or ()), ()),
    ]
    for option, value, supported in unported:
        if value != supported:
            raise NotImplementedError(f"{option}={value!r} is not ported yet")
    fusion_type = fusion_cfg.get("type", "cross_transformer")
    if fusion_type not in FUSION_TYPES:
        raise ValueError(f"cross_type={fusion_type!r} not implemented")
    clip = [k for k in CLIP_FEATURE_DIMS if narr.get(k, False)]
    if len(clip) > 1:
        # JAX's layer would take F from whichever clip features the batch holds.
        raise ValueError(f"narration_embeds: one clip-feature source, not {clip}")
    if fusion_type != "cross_transformer":
        if fusion_cfg.get("share_encoders"):
            raise ValueError("share_encoders is a cross_transformer-wrapper feature "
                             "(CrossFusionBoxWrapperShared, cross_f_box_wrapper.py:305)")
        if clip:
            raise ValueError("clip-feature fusion subclasses the cross_transformer wrapper "
                             "only (cross_f_box_vis_language_wrapper.py)")
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
        fusion_type=fusion_type,
        asymm_lang_layers=fargs.get("lang_layers", 2),
        asymm_vis_dropout=fargs.get("vis_dropout", fargs.get("token_dropout", 0.1)),
        asymm_lang_dropout=fargs.get("lang_dropout", fargs.get("token_dropout", 0.1)),
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
        pos_embedding=fusion_cfg.get("pos_embedding", "sin1d"),
        final_norm=fargs.get("final_norm", "ln"),
        activation=fargs.get("activ_f", "gelu"),
        vis_mask_type=fusion_cfg.get("vis_mask_type", "global"),
        forward_language_f=fusion_cfg.get("forward_language_f", False),
        replace_fpn_features=fusion_cfg.get("replace_fpn_features", True),
        share_encoders=bool(fusion_cfg.get("share_encoders", False)),
        use_flash_attention=bool(fargs.get("use_flash_attention", True)),
    )
    lm_args = fusion_cfg.get("lm_args") or {}
    pooling = lm_args.get("pooling", {})
    return TransFusionConfig(detector=det, fusion=fus, bert=bert,
                             narr_out_mode=fusion_cfg.get("narr_out_mode", "tokens"),
                             out_mlp=narr_args.get("out_mlp"),
                             out_dropout=narr_args.get("out_dropout", 0.1),
                             lm_on=bool(criterion.get("lm", 0)),
                             lm_pooling=pooling.get("type", "mean"),
                             lm_use_ln=bool(pooling.get("ln", True)),
                             lm_multi=lm_args.get("multi", False),
                             lm_use_f=bool(lm_args.get("use_lm_f", False)),
                             use_visual_features=bool(clip),
                             clip_features=clip[0] if clip else TransFusionConfig.clip_features,
                             dtype=dtype)


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
        f, dt = cfg.fusion, cfg.dtype
        if f.fusion_type not in FUSION_TYPES:
            raise ValueError(f"cross_type={f.fusion_type!r} not implemented")
        if cfg.text_encoder != "sbert":
            raise NotImplementedError("only the sbert text encoder is ported")
        check_attention_head_dim(cfg, dev)
        super().__init__(cfg.detector, device=dev)
        self.tcfg = cfg
        self.narr_pooling_layer = NarrationEncoder(cfg.bert, cfg.out_mlp, dt, cfg.out_dropout,
                                                   cfg.narr_out_mode)
        cross = f.fusion_type == "cross_transformer"
        d = f.token_dim
        if cross and f.share_encoders:
            self.shared_t_encoder = _TEncoder([
                EncoderLayer(d, f.num_heads, f.ff_multiplier, dt, f.use_flash_attention,
                             f.token_dropout, f.activation)
                for _ in range(f.num_layers[0])])
        if cross and cfg.use_visual_features:
            self.vis_fusion = nn.ModuleList([
                VisualFeatureFusion(d, cfg.visual_feature_dim, cfg.visual_feature_layers,
                                    f.num_heads, dtype=dt)
                for _ in f.fpn_features])
        self.patches_to_token = nn.ModuleList()
        self.tokens_to_features = nn.ModuleList()
        self.cross_fusion_encoders = nn.ModuleList()
        for i, lvl in enumerate(f.fpn_features):
            c = RESNET50_CHANNELS[str(lvl)]
            ph, pw = f.patch_h[i], f.patch_w[i]
            self.patches_to_token.append(nn.Conv2d(c, d, (ph, pw), stride=(ph, pw), bias=False))
            self.tokens_to_features.append(RegroupPatches(d, c, ph, pw))
            if cross:
                level = CrossFusionLevel(
                    d, 0 if f.share_encoders else f.num_layers[i], f.num_heads, f.ff_multiplier,
                    (ph, pw), f.vis_mask_type, f.use_flash_attention, dt, f.token_dropout,
                    f.patch_dropout, f.backproj_dropout, f.pos_embedding, f.final_norm, f.activation)
            elif f.fusion_type == "asymmetric":
                # num_layers[i] is the visual depth.
                level = AsymmetricCrossFusionLevel(
                    d, f.num_layers[i], f.asymm_lang_layers, f.num_heads, f.ff_multiplier, (ph, pw),
                    f.asymm_vis_dropout, f.asymm_lang_dropout, f.patch_dropout, f.pos_embedding,
                    f.activation, dt)
            else:
                level = SpaceTimeFusionLevel(
                    d, f.num_layers[i], f.num_heads, f.ff_multiplier, (ph, pw), f.token_dropout,
                    f.patch_dropout, f.backproj_dropout, f.activation, f.pos_embedding,
                    f.final_norm, dt)
            self.cross_fusion_encoders.append(level)
        if cfg.lm_on:
            roi = cfg.detector.roi

            def head():
                return PoolPredictor(d, roi.num_nouns - 1, roi.num_verbs - 1, cfg.lm_pooling,
                                     cfg.lm_use_ln, dt)

            if cfg.lm_multi == "sep" and not cfg.lm_use_f:
                self.lm_layers = nn.ModuleList([head() for _ in f.fpn_features])
            else:
                self.lm_layer = head()
        self.to(dev).eval()

    def _trunk(self, batch: dict, rng=None):
        """Backbone -> per-level language fusion -> FPN. Each level sees the
        language the previous one forwards (``forward_language_f``: its
        fused tokens "direct", or their "sum" with what it was given; the
        encoder's tokens otherwise) and its fused map replaces the backbone
        map (``replace_fpn_features``). Returns (FPN maps, the language
        context of the LM head)."""
        c, f = self.tcfg, self.tcfg.fusion
        feats = self.forward_features(batch["image"])
        dev = self.device
        lang, lang_mask = self.narr_pooling_layer(batch["input_ids"].to(dev),
                                                  batch["attention_mask"].to(dev), rng)
        if lang.dim() == 2:
            # Embedding mode: the sentence vector is one fully attended token.
            lang = lang[:, None]
            lang_mask = torch.ones((lang.shape[0], 1), dtype=lang_mask.dtype, device=dev)
        vis_f = batch.get("visual_features") if c.use_visual_features else None
        if vis_f is not None:
            vis_f = vis_f.to(dev)
        shared = getattr(self, "shared_t_encoder", None)
        language_f, lang_out, mscale = lang, None, []
        for i, lvl in enumerate(f.fpn_features):
            key = str(lvl)
            extra = {}
            if f.fusion_type == "cross_transformer":
                extra = {"shared_layers": None if shared is None else shared.layers,
                         "vis_fusion": self.vis_fusion[i] if c.use_visual_features else None}
            fused, lang_out = self.cross_fusion_encoders[i](
                feats[key], language_f, lang_mask, self.patches_to_token[i], self.tokens_to_features[i],
                rng, visual_features=vis_f, **extra)
            mscale.append(lang_out)
            if f.forward_language_f == "direct":
                language_f = lang_out
            elif f.forward_language_f == "sum":
                language_f = language_f + lang_out
            if f.replace_fpn_features:
                feats[key] = fused
        ctx = {"language_f": language_f, "lang_out": lang_out, "mscale_lang": mscale,
               "lang_mask": lang_mask}
        return self.apply_fpn(feats), ctx

    def trunk(self, batch: dict, rng=None):
        """The FPN maps of :meth:`_trunk`."""
        return self._trunk(batch, rng)[0]

    def _lm_outputs(self, ctx: dict) -> dict:
        """The LM head's logits (get_lm_layer dispatch and use_lm_f)."""
        c = self.tcfg
        mask = ctx["lang_mask"].bool()
        if c.lm_use_f:
            return self.lm_layer(ctx["language_f"], mask)
        if c.lm_multi == "sep":
            return _mean_lm_outs([head(t, mask) for head, t in zip(self.lm_layers, ctx["mscale_lang"])])
        if c.lm_multi:
            return _mean_lm_outs([self.lm_layer(t, mask) for t in ctx["mscale_lang"]])
        return self.lm_layer(ctx["lang_out"], mask)

    def forward(self, batch: dict, train: bool = False, draws=None, generator=None, rng=None):
        """Returns {"roi_outputs", "proposals", "image_sizes"[, "lm"]} (see
        ``FasterRCNN.apply_rpn_roi`` for ``train``, ``draws``, ``generator``
        and ``rng``)."""
        fpn_feats, ctx = self._trunk(batch, rng)
        out = self.apply_rpn_roi(fpn_feats, batch["image_hw"], batch.get("targets"), train, draws,
                                 generator, rng)
        if self.tcfg.lm_on:
            out["lm"] = self._lm_outputs(ctx)
        return out

    def eval_with_losses(self, batch: dict, draws=None, generator=None):
        """One eval forward giving {"eval": every proposal's RoI outputs, for
        the detections; "loss": the same trunk's RPN labels and sampled RoIs
        (``draws`` / ``generator`` as in ``apply_roi``), for the
        validation losses}, each with the LM logits where the head is on.
        Both branches take one set of eval proposals. Dropout stays off
        (eval mode)."""
        fpn_feats, ctx = self._trunk(batch)
        hw = batch["image_hw"]
        rpn_out = self.propose(fpn_feats, hw)
        out = {"eval": self.apply_roi(fpn_feats, rpn_out, hw),
               "loss": self.apply_roi(fpn_feats, rpn_out, hw, batch["targets"], True, draws, generator)}
        if self.tcfg.lm_on:
            lm = self._lm_outputs(ctx)
            out["eval"]["lm"] = out["loss"]["lm"] = lm
        return out
