"""The TransFusion model: Faster R-CNN + narration encoder + per-level
fusion + the LM auxiliary head + the transformer TTC head (port of
``transfusion_tpu/models/transfusion.py``: the ``cross_transformer``,
``asymmetric`` and ``space_time`` fusion families, the encoder stack shared
across levels, clip-feature early fusion, every positional kind, language
forwarding across levels, the sbert, GPT-2 and T5 towers in tokens or
embedding mode, the identity path of precomputed language features, no
language at all, the LM head, and the TTC head's second pass, for eval,
validation with losses and training), and ``build_transfusion_config`` from
a derived run config.

``TransFusion`` subclasses :class:`FasterRCNN` so its state dict has the
reference's flat names (``backbone.*``, ``rpn.*``, ``roi_heads.*``,
``patches_to_token.i``, ``tokens_to_features.i``,
``cross_fusion_encoders.i``, ``narr_pooling_layer.*``, ``lm_layer.*``), and,
where JAX's tree has no reference name, names after JAX's modules
(``shared_t_encoder.layers.j`` for ``shared_layer_j``, ``vis_fusion.i`` for
``vis_fusion_<lvl>``, ``lm_layers.i`` for ``lm_layer_i``,
``ttc_hand_head.*``). ``forward`` takes the JAX batch contract: ``image [B,
H, W, 3]``, ``input_ids``, ``attention_mask``, ``image_hw``,
``visual_features [B, T, F]`` for the clip-feature fusion, ``type_mask`` for
the type embeddings, ``language_f`` (and ``language_mask``) for the identity
path, ``hand_boxes`` / ``hand_poses`` for the TTC head and, to train,
``targets``. As in JAX, ``forward(batch, train=True)`` assigns targets and
samples RoIs, and with the TTC head runs its second pass on the sampled
RoIs' detections; dropout follows the module's ``.train()`` / ``.eval()``
mode and draws from the ``rng`` (a ``text_encoder.DropoutRNG``) the train
step passes. ``eval_with_losses`` runs the trunk once and two RoI branches
on it: every proposal for the detections, and sampled RoIs for the
validation losses.
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
from transfusion_torch.models.detector import detections_from_outputs
from transfusion_torch.models.lm_encoders import (
    GPT2Config, GPT2Encoder, PooledLMEncoder, T5Config, T5Encoder, t5_config)
from transfusion_torch.models.resnet import RESNET50_CHANNELS
from transfusion_torch.models.roi_heads import RoIConfig
from transfusion_torch.models.rpn import RPNConfig
from transfusion_torch.models.text_encoder import BertConfig, NarrationEncoder
from transfusion_torch.models.ttc_head import TTCHeadConfig, TTCPredictionHead
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
    # The language tower: "sbert" (BERT/MiniLM), "gpt2" (distilgpt2),
    # "t5" (a T5 encoder stack), or "identity" (precomputed language
    # features from the batch's language_f, no tower).
    text_encoder: str = "sbert"
    # "tokens" feeds per-token features to the fusion; "embedding" one pooled
    # sentence vector as a single fully attended language token.
    narr_out_mode: str = "tokens"
    gpt2: GPT2Config | None = None  # text_encoder "gpt2"
    t5: T5Config | None = None      # text_encoder "t5"
    out_mlp: int | None = 896
    out_tanh: bool = False
    out_dropout: float = 0.1
    lm_on: bool = False
    lm_pooling: str = "mean"
    lm_use_ln: bool = True
    # False: one head on the last level's fused language; True: one head
    # averaged over every level's; "sep": a head per level, averaged.
    lm_multi: object = False
    # Classify the language features the last level was given instead.
    lm_use_f: bool = False
    # Inline narration type embeddings (the sbert tower only).
    type_embeddings: tuple = ()
    type_embedding_init_div: float = 1.0
    # False: no tower, no fusion, no LM head; the detector alone.
    use_language: bool = True
    # Clip-feature early fusion: batch["visual_features"] [B, T, F] fuses
    # with each level's patch tokens before the language stage.
    use_visual_features: bool = False
    visual_feature_layers: int = 2
    # The clip flag that is on: it fixes F, which JAX's layer reads from the
    # batch and the port's needs at build (visual_feature_dim).
    clip_features: str = "slowfast_f_v"
    # The transformer TTC head over the postprocessed detections
    # (ttc_hand_head.use): its config, and the detections an image it scores.
    ttc_hand: TTCHeadConfig | None = None
    max_ttc_boxes: int = 5
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
    does, with its ValueErrors: every fusion family and option, the LM head,
    the sbert / GPT-2 / T5 / identity language towers (or none), and the
    linear or transformer TTC head. The port builds a ResNet-50 family trunk
    with frozen BN and the plain stem; another backbone, live BN or the s2d
    stem raises NotImplementedError naming the option. Flash attention is on
    unless the fusion args turn it off, as in JAX."""
    run, model = config["run"], config["model"]
    rcnn_kwargs = model.get("rcnn_kwargs", {})
    narr = run["narration_embeds"]
    narr_args = narr["args"]
    fusion_cfg = run["narr_fusion"]
    fargs = fusion_cfg.get("args", {})
    criterion = run["criterion"]
    bn = model.get("batch_norm") or {}
    unported = [
        ("model.type", model.get("type", "res50"), "res50"),
        ("model.batch_norm.use", bool(bn.get("use", False)), False),
        ("model.s2d_stem", bool(model.get("s2d_stem", False)), False),
    ]
    for option, value, supported in unported:
        if value != supported:
            raise NotImplementedError(f"{option}={value!r} is not ported yet")
    # The transformer TTC head and its hand history (model.ttc_hand_head,
    # run.hand_args).
    ttc_hand, max_ttc_boxes = None, 5
    tth = model.get("ttc_hand_head") or {}
    if criterion.get("ttc", 0) and tth.get("use"):
        hand_args = run.get("hand_args") or {}
        if not hand_args.get("use"):
            raise ValueError("model.ttc_hand_head.use requires run.hand_args.use")
        ttc_hand = TTCHeadConfig(
            feat_dim=tth.get("feat_dim", 1024), ff_dim=tth.get("ff_dim", 1024),
            num_heads=tth.get("num_heads", 4), num_layers=tth.get("num_layers", 4),
            dropout=tth.get("dropout", 0.1), num_steps=hand_args.get("num_steps", 5),
            emb_steps_hand=tth.get("emb_steps_hand", 100),
            emb_steps_object=tth.get("emb_steps_object", 100),
            hand_feat_dim=hand_args.get("hand_feat_dim", 63),
            object_feat_dim=model["representation_size"])
        max_ttc_boxes = tth.get("max_ttc_boxes_per_image", 5)
    # The language tower: a non-learnable text pooling reads precomputed
    # features from the batch (identity); distilgpt2, t5-* / flan-t5-* and
    # the sbert variants build their towers.
    model_v = narr_args.get("model_v", "all-MiniLM-L12-v2")
    text_pooling = narr_args.get("text_pooling", "sbert_finetune")
    text_encoder, gpt2, t5 = "sbert", None, None
    bert = BertConfig.minilm_l12()
    if narr_args.get("pooling") == "sbert" or text_pooling not in ("sbert_finetune", "gpt2", "t5-wikihow"):
        text_encoder = "identity"
    elif model_v == "distilgpt2":
        text_encoder, gpt2 = "gpt2", GPT2Config()
    elif model_v.startswith(("t5-", "flan-t5-")):
        text_encoder, t5 = "t5", t5_config(model_v)
    elif model_v == "minilm-tiny":
        bert = BertConfig(hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128)
    elif "L6" in model_v:
        bert = BertConfig(num_layers=6)
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
        ttc_hand=ttc_hand is not None,
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
    return TransFusionConfig(detector=det, fusion=fus, bert=bert, text_encoder=text_encoder,
                             narr_out_mode=fusion_cfg.get("narr_out_mode", "tokens"),
                             gpt2=gpt2, t5=t5,
                             out_mlp=narr_args.get("out_mlp"),
                             out_tanh=bool(narr_args.get("out_tanh", False)),
                             out_dropout=narr_args.get("out_dropout", 0.1),
                             lm_on=bool(criterion.get("lm", 0)),
                             lm_pooling=pooling.get("type", "mean"),
                             lm_use_ln=bool(pooling.get("ln", True)),
                             lm_multi=lm_args.get("multi", False),
                             lm_use_f=bool(lm_args.get("use_lm_f", False)),
                             type_embeddings=tuple(narr_args.get("type_embeddings") or ()),
                             type_embedding_init_div=narr_args.get("type_embedding_init_div", 1.0),
                             use_language=bool(narr.get("use", True)),
                             use_visual_features=bool(clip),
                             clip_features=clip[0] if clip else TransFusionConfig.clip_features,
                             ttc_hand=ttc_hand, max_ttc_boxes=max_ttc_boxes,
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
        if cfg.text_encoder not in ("sbert", "gpt2", "t5", "identity"):
            raise ValueError(f"text_encoder={cfg.text_encoder!r}: one of sbert, gpt2, t5, identity")
        if cfg.use_language:
            check_attention_head_dim(cfg, dev)
        super().__init__(cfg.detector, device=dev)
        self.tcfg = cfg
        if cfg.use_language:
            self._build_language(cfg)
        if cfg.ttc_hand is not None:
            self.ttc_hand_head = TTCPredictionHead(cfg.ttc_hand, dt)
        self.to(dev).eval()

    def _build_language(self, cfg: TransFusionConfig):
        """The narration tower (none for the identity path), the fusion
        levels and the LM head."""
        f, dt = cfg.fusion, cfg.dtype
        if cfg.text_encoder in ("gpt2", "t5"):
            tower = (GPT2Encoder(cfg.gpt2, dt) if cfg.text_encoder == "gpt2"
                     else T5Encoder(cfg.t5, dt))
            self.narr_pooling_layer = PooledLMEncoder(tower, cfg.narr_out_mode, cfg.out_mlp,
                                                      cfg.out_tanh, cfg.out_dropout, dt)
        elif cfg.text_encoder == "sbert":
            self.narr_pooling_layer = NarrationEncoder(
                cfg.bert, cfg.out_mlp, dt, cfg.out_dropout, cfg.narr_out_mode, cfg.out_tanh,
                cfg.type_embeddings, cfg.type_embedding_init_div)
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

    def _language(self, batch: dict, rng=None):
        """The language tokens [B, L, D] and their mask [B, L]: the tower's,
        or the identity path's batch["language_f"] (with
        batch["language_mask"], else all ones; a 2-D [B, D] is one token)."""
        c, dev = self.tcfg, self.device
        if c.text_encoder == "identity":
            lang = batch["language_f"].to(device=dev, dtype=c.dtype)
            mask = batch.get("language_mask")
            if mask is None:
                mask = torch.ones(lang.shape[:2] if lang.dim() == 3 else (lang.shape[0], 1),
                                  dtype=torch.int64, device=dev)
            mask = mask.to(dev)
        else:
            extra = {}
            if c.text_encoder == "sbert" and c.type_embeddings and "type_mask" in batch:
                extra["type_mask"] = batch["type_mask"]
            lang, mask = self.narr_pooling_layer(batch["input_ids"].to(dev),
                                                 batch["attention_mask"].to(dev), rng, **extra)
        if lang.dim() == 2:
            # A sentence vector (embedding mode, or a 2-D language_f) is one
            # fully attended token.
            lang = lang[:, None]
            mask = torch.ones((lang.shape[0], 1), dtype=mask.dtype, device=dev)
        return lang, mask

    def _trunk(self, batch: dict, rng=None):
        """Backbone -> per-level language fusion -> FPN. Each level sees the
        language the previous one forwards (``forward_language_f``: its
        fused tokens "direct", or their "sum" with what it was given; the
        encoder's tokens otherwise) and its fused map replaces the backbone
        map (``replace_fpn_features``). Returns (FPN maps, the language
        context of the LM head)."""
        c, f = self.tcfg, self.tcfg.fusion
        feats = self.forward_features(batch["image"])
        if not c.use_language:
            return self.apply_fpn(feats), None
        dev = self.device
        lang, lang_mask = self._language(batch, rng)
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
        c = self.tcfg
        fpn_feats, ctx = self._trunk(batch, rng)
        out = self.apply_rpn_roi(fpn_feats, batch["image_hw"], batch.get("targets"), train, draws,
                                 generator, rng)
        if c.use_language and c.lm_on:
            out["lm"] = self._lm_outputs(ctx)
        if c.ttc_hand is not None and train and "hand_boxes" in batch:
            # The training second pass: the detections of the sampled RoIs
            # (no gradient through the postprocess), the head on their
            # detached box features and the hand history; the TTC criterion
            # trains the head alone.
            with torch.no_grad():
                dets = detections_from_outputs(out, c.detector, training=True)
            roi = dict(out["roi_outputs"], box_features=out["roi_outputs"]["box_features"].detach())
            second = self.predict_ttc(dets, roi, batch, batch["image_hw"], training=True, rng=rng)
            k = min(c.max_ttc_boxes, second["ttcs"].shape[1])
            out["ttc_hand"] = {"ttcs": second["ttcs"][:, :k], "valid": second["valid"][:, :k]}
        return out

    def predict_ttc(self, dets: dict, roi_outputs: dict, batch: dict, image_hw,
                    training: bool = False, rng=None) -> dict:
        """The transformer TTC head's pass over the first ``max_ttc_boxes``
        detections an image: their RoI box features, their boxes normalised
        by the image size, the batch's hand boxes and poses. The head's
        softplus is followed by the reference's second one, and in eval
        under the additional postprocessing by the MIN_TTC clamp. Returns
        ``dets`` with those detections' TTCs replaced where they are valid."""
        c = self.tcfg
        dev = self.device
        k = min(c.max_ttc_boxes, dets["boxes"].shape[1])
        bf = roi_outputs["box_features"]                                     # [B, R, repr]
        bsz = bf.shape[0]
        idx = dets["prop_idx"][:, :k].long()
        feats = torch.gather(bf, 1, idx[..., None].expand(-1, -1, bf.shape[-1]))
        h, w = image_hw
        wh = torch.tensor([w, h, w, h], dtype=torch.float32, device=dev)
        obj = dets["boxes"][:, :k].float() / wh
        inputs = {"box_features": feats.reshape(bsz * k, -1),
                  "object_boxes": obj.reshape(bsz * k, 1, 4),
                  "hand_boxes": batch["hand_boxes"].to(dev).repeat_interleave(k, 0),
                  "hand_poses": batch["hand_poses"].to(dev).repeat_interleave(k, 0)}
        ttc = torch.nn.functional.softplus(self.ttc_hand_head(inputs, rng if training else None))
        if not training and c.detector.roi.additional_postprocessing:
            ttc = torch.clamp(ttc, min=c.detector.roi.min_ttc)
        ttc = ttc.reshape(bsz, k)
        old = dets["ttcs"]
        head = torch.where(dets["valid"][:, :k], ttc.to(old.dtype), old[:, :k])
        return dict(dets, ttcs=torch.cat([head, old[:, k:]], 1))

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
        if self.tcfg.use_language and self.tcfg.lm_on:
            lm = self._lm_outputs(ctx)
            out["eval"]["lm"] = out["loss"]["lm"] = lm
        return out
