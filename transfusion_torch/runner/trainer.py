"""The config-driven training/eval orchestrator (port of
``transfusion_tpu/runner/trainer.py``): the epoch freeze rules, the data
(:func:`build_trainer_data`), and :class:`EgoNaoTrainer` (model, steps,
resume and pretrained init, ``train_epoch``, ``evaluate`` to the Ego4D STA
challenge JSON with STA mAP and real validation losses, and ``fit`` with a
checkpoint an epoch, ``history.jsonl`` and ``best.json``).

The freeze rules work over the port's ``named_parameters()``. The JAX
parameter paths map onto the port's reference names: ``backbone`` (the
ResNet body; JAX keeps the FPN outside it) is ``backbone.body.*``, its stem
``backbone.body.conv1``, stage ``layerN`` ``backbone.body.layerN.*``;
``narr_encoder`` is ``narr_pooling_layer.*`` with BERT layer ``layer_i`` at
``...encoder.layer.i.``, GPT-2 block ``h_i`` at ``...transformer.h.i.`` and
T5 block ``block_i`` at ``...encoder.block.i.``; the RoI heads (``box_head``/``predictors``) are
``roi_heads.*``. JAX holds the frozen BatchNorm vectors as parameters, the
port as buffers: with these multipliers a frozen backbone moves in neither.

The trainer runs on one device (``cuda`` unless ``device`` names another).
Only :func:`build_trainer_data` reads files, and only it needs pandas,
Pillow, OpenCV or PyYAML (through the data modules it calls); a caller may
hand the trainer a :class:`TrainerData` instead.
"""

from __future__ import annotations

import json
import logging
import os
import re
import time
from dataclasses import dataclass, replace

import numpy as np
import torch

from transfusion_torch.data.loader import DataLoader
from transfusion_torch.data.tokenizer import (GPT2BPETokenizer, SentencePieceTokenizer,
                                              WordPieceTokenizer, hash_gpt2_tokenizer,
                                              hash_t5_tokenizer, hash_vocab_tokenizer)
from transfusion_torch.data.transforms import AugConfig
from transfusion_torch.device import resolve_device
from transfusion_torch.metrics import STAMeanAveragePrecision
from transfusion_torch.models.transfusion import TransFusion, build_transfusion_config
from transfusion_torch.runner.export import detections_to_results, write_result_json
from transfusion_torch.train.checkpoint import (CheckpointManager, map_tensors,
                                                monitor_metric_name, replace_heads, tolerant_merge)
from transfusion_torch.train.losses import build_class_weights
from transfusion_torch.train.optim import make_optimizer
from transfusion_torch.train.step import (LossConfig, TrainState, criterion_weights,
                                          make_eval_loss_step, make_train_step,
                                          normalized_criterion_weights)
from transfusion_torch.weights import init_random_, strip_wrapper_prefixes

log = logging.getLogger("transfusion_torch")


def build_tokenizer(model_v: str, max_length: int = 128):
    """Host-side tokenizer of the language tower the config selects, from
    vocab files named by environment variables:
      * sbert variants: TOKENIZER_VOCAB -> WordPiece vocab.txt;
      * distilgpt2:     GPT2_VOCAB_JSON + GPT2_MERGES (or TOKENIZER_DIR's
                        vocab.json and merges.txt) -> byte-level BPE;
      * t5-*/flan-t5-*: T5_SPM (or TOKENIZER_DIR/spiece.model) ->
                        SentencePiece unigram.
    Without the files each falls back to a deterministic hash tokenizer
    (not checkpoint-compatible; a warning is logged)."""
    tok_dir = os.environ.get("TOKENIZER_DIR", "")
    if model_v == "distilgpt2":
        vj = os.environ.get("GPT2_VOCAB_JSON", os.path.join(tok_dir, "vocab.json"))
        mg = os.environ.get("GPT2_MERGES", os.path.join(tok_dir, "merges.txt"))
        if os.path.isfile(vj) and os.path.isfile(mg):
            return GPT2BPETokenizer.from_files(vj, mg, max_length=max_length)
        log.warning("no GPT-2 vocab/merges files; using hash-fallback BPE tokenizer")
        return hash_gpt2_tokenizer(max_length=max_length)
    if model_v.startswith(("t5-", "flan-t5-")):
        spm = os.environ.get("T5_SPM", os.path.join(tok_dir, "spiece.model"))
        if os.path.isfile(spm):
            return SentencePieceTokenizer.from_model_file(spm, max_length=max_length)
        log.warning("no T5 spiece.model; using hash-fallback unigram tokenizer")
        return hash_t5_tokenizer(max_length=max_length)
    vocab_path = os.environ.get("TOKENIZER_VOCAB", "")
    if vocab_path and os.path.isfile(vocab_path):
        return WordPieceTokenizer.from_vocab_file(vocab_path, max_length=max_length)
    log.warning("no TOKENIZER_VOCAB file; using deterministic hash vocab")
    return hash_vocab_tokenizer(max_length=max_length)


def dataset_root(config: dict) -> str:
    name = config["dataset"]["name"]
    sub = {"ego4d": "Ego4d/v1", "ego4djpg": "Ego4d/v1", "ego4djpgv2": "Ego4d/v2"}[name]
    return os.path.join(os.path.expandvars("$DATA"), sub)


def backbone_stop_grad_stages(epoch: int, model_cfg: dict, freeze_backbone_at_epoch: int = -1) -> int:
    """Frozen-prefix depth of the ResNet body for the epoch's train step:
    the whole body [stem..layer4] (5) before ``train_ep`` or with
    ``train_ep == -1``; afterwards all but the deepest ``trainable_layers``;
    ``freeze_backbone_at_epoch`` refreezes everything."""
    if str(model_cfg.get("type", "res50")).startswith("mobilenet"):
        raise NotImplementedError("the MobileNet backbone is not ported yet")
    train_ep = model_cfg.get("train_ep", -1)
    backbone_on = train_ep != -1 and epoch >= train_ep
    if freeze_backbone_at_epoch != -1 and epoch >= freeze_backbone_at_epoch:
        backbone_on = False
    if not backbone_on:
        return 5
    return max(5 - min(int(model_cfg.get("trainable_layers", 0)), 5), 0)


def unfreeze_multipliers(named_params, epoch: int, model_cfg: dict, narr_train_ep: int,
                         narr_finetune_layers: int, num_bert_layers: int,
                         freeze_backbone_at: int = -1, text_encoder: str = "sbert") -> dict:
    """{parameter name: 0.0 or 1.0} for the epoch: the backbone body is
    frozen until ``train_ep`` and then only its ``trainable_layers`` deepest
    units train; the narration encoder trains its ``out_mlp`` and, from its
    ``train_ep``, its unfreeze set: the last ``finetune_layers`` BERT layers
    (sbert), the last block's MLP (GPT-2) or the last block (T5), with
    ``num_bert_layers`` the tower's depth; ``freeze_backbone_at`` leaves only
    the RoI heads training."""
    if str(model_cfg.get("type", "res50")).startswith("mobilenet"):
        raise NotImplementedError("the MobileNet backbone is not ported yet")
    train_ep = model_cfg.get("train_ep", -1)
    trainable_layers = model_cfg.get("trainable_layers", 0)
    backbone_on = train_ep != -1 and epoch >= train_ep
    # layers_to_train = [layer4, layer3, layer2, layer1, stem][:trainable_layers]
    unfrozen_units = {f"layer{4 - i}" for i in range(min(trainable_layers, 4))}
    if trainable_layers == 5:
        unfrozen_units |= {"conv1", "bn1"}  # the stem
    narr_on = narr_train_ep != -1 and epoch >= narr_train_ep
    if text_encoder == "gpt2":
        tower = re.compile(rf"\.transformer\.h\.{num_bert_layers - 1}\.mlp\.")
    elif text_encoder == "t5":
        tower = re.compile(rf"\.encoder\.block\.{num_bert_layers - 1}\.")
    else:
        last = "|".join(str(num_bert_layers - 1 - i) for i in range(narr_finetune_layers))
        tower = re.compile(rf"\.encoder\.layer\.({last})\.") if last else None
    roi_only = freeze_backbone_at != -1 and epoch >= freeze_backbone_at

    def assign(name: str) -> float:
        if roi_only:
            return 1.0 if name.startswith("roi_heads.") else 0.0
        if name.startswith("backbone.body."):
            return 1.0 if backbone_on and name.split(".")[2] in unfrozen_units else 0.0
        if name.startswith("narr_pooling_layer."):
            if ".out_mlp." in name:
                return 1.0
            return 1.0 if narr_on and tower is not None and tower.search(name) else 0.0
        return 1.0

    return {name: assign(name) for name, _ in named_params}


def tower_depth(cfg) -> int:
    """The language tower's number of layers (the unfreeze rules' depth)."""
    tower = {"gpt2": cfg.gpt2, "t5": cfg.t5}.get(cfg.text_encoder, cfg.bert)
    return tower.num_layers


@dataclass
class TrainerData:
    """What the trainer reads from the dataset: the three splits (objects
    with ``__len__``, ``get_example(idx, rng, bucket, training)``,
    ``num_nouns``, ``num_verbs`` and ``aug``), the label mappings, the class
    weights with their background slots, the noun -> verb train frequencies
    [num_nouns, num_verbs], the augmentation config and the tokenizer."""

    train_ds: object
    val_ds: object
    test_ds: object
    noun_mapping: dict
    verb_mapping: dict
    noun_w: object
    verb_w: object
    noun_verb_freqs: object
    aug: AugConfig
    tokenizer: object


def build_trainer_data(config: dict, debug: bool = False) -> TrainerData:
    """The trainer's data from the dataset files (``EgoNaoTrainer._build_data``
    of the JAX package, ``transfusion_tpu/runner/trainer.py:261-396``):
    annotations, label mappings, split, class weights, frequencies,
    narrations, the hand history and precomputed narration vectors where the
    config asks for them, datasets and tokenizer."""
    from transfusion_torch.data.annotations import load_sta_annotations
    from transfusion_torch.data.dataset import EgoNaoDataset, build_narration_lookup
    from transfusion_torch.data.labels import (balanced_class_weights, frequencies_to_array,
                                               get_label_mapping, noun_verb_frequencies)
    from transfusion_torch.data.splits import apply_split, load_split

    run = config["run"]
    ds_args = config["dataset"]["args"]
    narr_args = run["narration_embeds"]["args"]
    root = dataset_root(config)
    annots = load_sta_annotations(
        root,
        resize_boxes=config["dataset"]["name"] == "ego4d",
        narr_structure=ds_args.get("narr_structure", "{gt_narr}"),
        narr_external_paths=ds_args.get("narr_external_paths", []),
    )
    if debug:
        annots = annots[annots["clip_id"].isin(annots["clip_id"].unique()[:2])]

    mapping_file = None
    if ds_args.get("use_external_label_mapping"):
        version = "v2" if config["dataset"]["name"].endswith("v2") else "v1"
        mapping_file = os.path.expandvars(
            f"$CODE/data_preprocessing/configs/label_mappings_{version}.json")
        if not os.path.isfile(mapping_file):
            mapping_file = None
    noun_mapping = get_label_mapping(annots["all_nouns"].explode(), "noun", mapping_file)
    verb_mapping = get_label_mapping(annots["all_verbs"].explode(), "verb", mapping_file)

    split = load_split(annots, config["split"])
    train_df, val_df, test_df = apply_split(annots, split, config["split"])
    if debug:
        train_df = train_df.iloc[:2000]

    aug_cfg = config["aug"]
    spec = aug_cfg["resize_spec"]
    aug = AugConfig(
        resize_spec=tuple(map(tuple, spec)) if isinstance(spec[0], (list, tuple)) else tuple(spec),
        crop_spec=tuple(aug_cfg.get("crop_spec", (1, 1))),
        flip=aug_cfg.get("flip", True),
        channel_order=aug_cfg.get("channel_order", "RGB"),
        brightness=aug_cfg.get("brightness", 0.0),
        contrast=aug_cfg.get("contrast", 0.0),
        saturation=aug_cfg.get("saturation", 0.0),
        hue=aug_cfg.get("hue", 0.0),
        normalization=run.get("normalization", "ego4d_baseline"),
    )
    lookup = build_narration_lookup(
        annots, narr_args.get("strategy", "current"),
        start_prompt=narr_args.get("start_prompt"), end_prompt=narr_args.get("end_prompt"),
        empty_prompt=narr_args.get("empty_prompt"), final_concat=narr_args.get("final_concat"),
    )
    uid_col = "video_uid" if config["dataset"]["name"].endswith("v2") else "video_id"
    hand_lookup = build_hand_lookup(run)
    narr_embed_lookup, narr_embedder = build_narration_vectors(narr_args)

    def make(df):
        return EgoNaoDataset(annots=df, frames_dir=os.path.join(root, "object_frames"),
                             noun_mapping=noun_mapping, verb_mapping=verb_mapping, aug=aug,
                             narration_lookup=lookup, uid_col=uid_col,
                             verb_bg=run.get("verb_bg", False), hand_pose_lookup=hand_lookup,
                             narration_embedding_lookup=narr_embed_lookup,
                             narration_embedding_dim=narr_args.get("size", 384),
                             narration_embedder=narr_embedder)

    train_ds, val_ds, test_ds = make(train_df), make(val_df), make(test_df)
    cutoff = ds_args.get("label_cutoff", {})
    dampen_n = cutoff.get("dampen", cutoff.get("dampen_noun", 1.0))
    dampen_v = cutoff.get("dampen", cutoff.get("dampen_verb", 1.0))
    noun_w, verb_w = build_class_weights(
        balanced_class_weights(train_df["all_nouns"].explode(), noun_mapping, dampen_n),
        balanced_class_weights(train_df["all_verbs"].explode(), verb_mapping, dampen_v),
        run.get("bg_weight", 1), run.get("verb_bg", False), run.get("all_class_w", False),
    )
    freqs = frequencies_to_array(noun_verb_frequencies(train_df, noun_mapping, verb_mapping),
                                 train_ds.num_nouns, train_ds.num_verbs)
    tokenizer = build_tokenizer(narr_args.get("model_v", "all-MiniLM-L12-v2"))
    type_names = tuple(narr_args.get("type_embeddings") or ())
    if type_names and hasattr(tokenizer, "encode_batch_with_types"):
        tokenizer.type_names = type_names
    return TrainerData(train_ds, val_ds, test_ds, noun_mapping, verb_mapping, noun_w, verb_w,
                       freqs, aug, tokenizer)


def build_hand_lookup(run: dict):
    """The FrankMocap hand history of the transformer TTC head
    (``run.hand_args``): a :class:`HandPoseLookup` over the cache at
    ``hand_args.path`` (environment variables expanded), zero-filled hands
    where that file is missing, None without ``hand_args.use``."""
    from transfusion_torch.data.hand_pose import HandPoseLookup, ZeroHandLookup

    hand_args = run.get("hand_args") or {}
    if not hand_args.get("use"):
        return None
    path = os.path.expandvars(hand_args.get("path", ""))
    if path and os.path.isfile(path):
        return HandPoseLookup(path, hand_args.get("num_steps", 5), hand_args.get("step", 5))
    log.warning("hand_args.use set but cache %r missing; hand inputs zero-filled", path)
    return ZeroHandLookup(hand_args.get("num_steps", 5))


def build_narration_vectors(narr_args: dict):
    """(uid -> vector lookup, narration embedder) of the identity text
    tower, else (None, None): the GloVe variant (``type: glove``,
    ``$DATA/glove.6B.{size}d.txt`` pooled per narration; an empty lookup,
    so zero vectors, where the table is missing), or for a non-learnable
    text pooling the pickle ``NARR_EMBED_CACHE`` of {uid: vector} (an empty
    lookup without it)."""
    tp = narr_args.get("text_pooling", "sbert_finetune")
    if narr_args.get("type") == "glove":
        from transfusion_torch.data.glove import GloveNarrationEmbedder

        embedder = GloveNarrationEmbedder.from_env(size=narr_args.get("size", 300),
                                                   pooling=narr_args.get("pooling", "max"),
                                                   normalize=narr_args.get("normalize", True))
        return ({} if embedder is None else None), embedder
    if narr_args.get("pooling") == "sbert" or tp not in ("sbert_finetune", "gpt2", "t5-wikihow"):
        cache = os.environ.get("NARR_EMBED_CACHE", "")
        if cache and os.path.isfile(cache):
            import pickle

            with open(cache, "rb") as fp:
                return pickle.load(fp), None
        log.warning("identity text tower without NARR_EMBED_CACHE; zero language_f")
        return {}, None
    return None, None


@dataclass
class EvalResult:
    metrics: dict
    result_json_path: str | None


class EgoNaoTrainer:
    """Trains and evaluates one run config on one device. ``data`` (a
    :class:`TrainerData`) replaces :func:`build_trainer_data`'s reading of
    the dataset files. The multi-device arguments (``mesh``, ``fsdp``,
    ``tp_min_dim``) are not ported yet and raise when set."""

    def __init__(self, config: dict, run_dir: str, debug: bool = False, mesh=None, seed=None,
                 fsdp: bool = False, tp_min_dim: int | None = None, device=None,
                 data: TrainerData | None = None):
        self.config = config
        self.run = config["run"]
        for option, value, default in (("mesh", mesh, None), ("fsdp", fsdp, False),
                                       ("run.fsdp", self.run.get("fsdp", False), False),
                                       ("tp_min_dim", tp_min_dim, None)):
            if value != default:
                raise NotImplementedError(f"{option}={value!r} (multi-device) is not ported yet")
        self.run_dir = run_dir
        os.makedirs(run_dir, exist_ok=True)
        self.debug = debug
        self.seed = seed if seed is not None else self.run.get("seed", 42)
        self.device = resolve_device(device)
        data = data if data is not None else build_trainer_data(config, debug)
        self.train_ds, self.val_ds, self.test_ds = data.train_ds, data.val_ds, data.test_ds
        self.noun_mapping, self.verb_mapping = data.noun_mapping, data.verb_mapping
        self.num_nouns, self.num_verbs = self.train_ds.num_nouns, self.train_ds.num_verbs
        self.noun_w, self.verb_w = data.noun_w, data.verb_w
        self.noun_verb_freqs = data.noun_verb_freqs
        self.aug, self.tokenizer = data.aug, data.tokenizer

        self._build_model()
        self._build_steps()
        self.ckpt = CheckpointManager(run_dir)
        self.monitor = monitor_metric_name(self.run["criterion"])
        self.history: list[dict] = []
        self.plotter = None  # the GT-vs-prediction plots are not ported yet

    # --------------------------------------------------------------- model
    def _set_stop_grad_stages(self, p: int):
        """Apply the epoch's frozen-prefix tape cut (see
        DetectorConfig.stop_grad_stages). The multipliers stay authoritative;
        the cut only removes the masked backbone's backward work, so the
        updates are unchanged. It changes no parameter: the live model and
        TrainState carry on."""
        det = self.model_cfg.detector
        if det.stop_grad_stages == p:
            return
        self.model_cfg = replace(self.model_cfg, detector=replace(det, stop_grad_stages=p))
        self.model.tcfg, self.model.cfg = self.model_cfg, self.model_cfg.detector
        self.model.backbone.body.stop_grad_prefix = p

    def _build_model(self):
        # precision 16 -> bf16 compute with f32 params; 32 -> f32.
        dtype = torch.bfloat16 if int(self.run.get("precision", 32)) == 16 else torch.float32
        self.model_cfg = build_transfusion_config(self.config, self.num_nouns, self.num_verbs,
                                                  dtype=dtype)
        self.model = TransFusion(self.model_cfg, device=self.device)
        self.train_bs = max(self.run["train_bs"], 1)
        self.val_bs = max(self.run["val_bs"], 1)
        if self.debug:
            self.train_bs, self.val_bs = min(self.train_bs, 10), min(self.val_bs, 10)

        steps_per_epoch = max(len(self.train_ds) // self.train_bs, 1)
        self.tx, self.lr_schedule = make_optimizer(
            self.run["optimizer"], self.run.get("scheduler"), steps_per_epoch,
            grad_clip=self.run.get("grad_clip"),
            accumulate=self.run.get("accumulate_grad_batches", 1),
        )
        criterion = self.run["criterion"]
        self.loss_cfg = LossConfig(
            bbox_on=bool(criterion.get("bbox", 0)),
            obj_prop_on=bool(criterion.get("obj_prop", 0)),
            noun_on=bool(criterion.get("noun", 0)),
            verb_on=bool(criterion.get("verb", 0)),
            ttc_on=bool(criterion.get("ttc", 0)),
            lm_on=bool(criterion.get("lm", 0)),
            agg_mean=criterion.get("agg", "mean") == "mean",
            ttc_beta=criterion.get("ttc_beta", 1),
            verb_bg=self.run.get("verb_bg", False),
            ttc_bg=bool(self.run.get("ttc_bg", False)),
            ttc_bg_val=float(self.run.get("ttc_bg_val") or 0.0),
            rpn_batch_size_per_image=self.config["model"]["rcnn_kwargs"].get(
                "rpn_batch_size_per_image", 256),
            last_noun_idx=self.num_nouns - 1,
        )
        self.criterion = criterion

    def _build_steps(self):
        self.train_step = make_train_step(self.model, self.tx, self.loss_cfg, self.noun_w,
                                          self.verb_w)
        # Detections and real validation losses from one trunk (the
        # reference logs its normalised-weight val loss over constant zeros,
        # ego_nao_trainer.py:407-427).
        self.eval_loss_step = make_eval_loss_step(
            self.model, self.model_cfg.detector, self.loss_cfg, self.noun_w, self.verb_w,
            noun_verb_frequencies=self.noun_verb_freqs)
        self.val_loss_w = normalized_criterion_weights(self.criterion)
        self.state = None

    # ---------------------------------------------------------------- init
    def ensure_state(self, resume_from: str | None = None):
        """Seeded weights and a fresh optimizer state, then the pretrained
        detector weights (``model.pretrained``) or the checkpoint
        ``resume_from``."""
        if self.state is not None:
            return
        init_random_(self.model, seed=self.seed)
        self.state = TrainState(step=0, opt_state=self.tx.init(dict(self.model.named_parameters())),
                                seed=self.seed)
        if not resume_from:
            pretrained = (self.config.get("model") or {}).get("pretrained")
            if isinstance(pretrained, str) and pretrained:
                self._load_pretrained_weights(pretrained)
            elif pretrained is True:
                log.warning("model.pretrained: True requests torchvision COCO weights (a "
                            "download); provide a checkpoint path instead. Training from "
                            "random init.")
            if not pretrained:
                log.warning("training from RANDOM init with frozen BatchNorm: the trunk is "
                            "unnormalized and detector losses converge pathologically slowly; "
                            "provide model.pretrained.")
            return
        fresh = {k: v.clone() for k, v in self.model.state_dict().items()}
        self.state = self.ckpt.restore(self.model, path=resume_from)
        if self.run.get("replace_heads", False) == "all":
            self.model.load_state_dict(replace_heads(self.model.state_dict(), fresh))

    def _load_pretrained_weights(self, path: str):
        """Cold-start init from pretrained detector weights (``model.pretrained``,
        rcnn_factory.py:85-108): a reference torch ``.pth``/``.ckpt`` (the
        port keeps its names, so the wrapper prefixes are stripped and the
        tensors loaded) or a port checkpoint directory. ``model.load_fpn_rpn:
        False`` keeps the FPN, RPN and RoI heads fresh."""
        path = os.path.expandvars(path)
        fresh = self.model.state_dict()
        if os.path.isdir(path):
            sd = torch.load(os.path.join(path, CheckpointManager.STATE), map_location="cpu",
                            weights_only=True)["model"]
        elif os.path.isfile(path):
            sd = torch.load(path, map_location="cpu", weights_only=False)
            sd = strip_wrapper_prefixes(sd.get("state_dict", sd))
        else:
            raise FileNotFoundError(f"model.pretrained path not found: {path}")
        merged = tolerant_merge(fresh, sd)
        if not (self.config.get("model") or {}).get("load_fpn_rpn", True):
            merged = {k: fresh[k] if k.startswith(("backbone.fpn.", "rpn.", "roi_heads.")) else v
                      for k, v in merged.items()}
        self.model.load_state_dict(merged)
        log.info("pretrained init: %d tensors from %s", sum(k in sd for k in fresh), path)

    # ---------------------------------------------------------------- train
    def _device_batch(self, batch, with_targets: bool = True) -> dict:
        """The model's inputs as tensors on the device (int32 -> int64)."""
        def put(x):
            t = torch.from_numpy(np.asarray(x))
            return (t.long() if t.dtype == torch.int32 else t).to(self.device, non_blocking=True)

        out = {k: put(batch[k]) for k in ("image", "input_ids", "attention_mask", "visual_features",
                                          "hand_boxes", "hand_poses", "type_mask", "language_f")
               if k in batch}
        if with_targets and "targets" in batch:
            out["targets"] = {k: put(v) for k, v in batch["targets"].items()}
        out["image_hw"] = tuple(int(v) for v in batch["image_hw"])
        return out

    def train_epoch(self, epoch: int) -> dict:
        self._set_stop_grad_stages(backbone_stop_grad_stages(
            epoch, self.config["model"], self.run.get("freeze_backbone_at_epoch", -1)))
        self.ensure_state()
        loader = DataLoader(self.train_ds, self.train_bs, tokenizer=self.tokenizer, training=True,
                            seed=self.seed, lang_max_length=self.tokenizer.max_length)
        loader.epoch = epoch
        loss_w = criterion_weights(self.criterion, epoch)
        narr = self.run["narration_embeds"]["args"]
        mult = unfreeze_multipliers(
            self.model.named_parameters(), epoch, self.config["model"], narr.get("train_ep", -1),
            narr.get("finetune_layers", 1), tower_depth(self.model_cfg),
            self.run.get("freeze_backbone_at_epoch", -1), text_encoder=self.model_cfg.text_encoder)
        agg: dict = {}
        n_steps = 0
        t0 = time.time()
        for batch in loader:
            metrics = self.train_step(self.state, self._device_batch(batch), loss_w, mult)
            n_steps += 1
            for k, v in metrics.items():
                agg[k] = agg.get(k, 0.0) + float(v)
        if agg.get("nonfinite_skipped", 0.0) > 0:
            log.warning("epoch %d: %d non-finite steps were skipped (NaN guard)",
                        epoch, int(agg["nonfinite_skipped"]))
        out = {f"train_{k}": v / max(n_steps, 1) for k, v in agg.items()}
        out["train_steps"] = n_steps
        out["train_time_s"] = round(time.time() - t0, 1)
        if loader.decode_times:
            out["train_decode_s_per_batch"] = round(float(np.mean(loader.decode_times)), 4)
        out["train_s_per_batch"] = round((time.time() - t0) / max(n_steps, 1), 4)
        loader.close()
        log.info("epoch %d train: %s", epoch, {k: round(v, 4) for k, v in out.items()})
        return out

    # ----------------------------------------------------------------- eval
    def evaluate(self, epoch: int, dataset=None, source: str = "val",
                 export: bool = True) -> EvalResult:
        """Detections and validation losses over ``dataset`` (the val split by
        default): STA mAP on the original resolution, the mean of each loss
        over batches, and the challenge JSON ``results/<source>_epoch<N>.json``."""
        self.ensure_state()
        ds = dataset if dataset is not None else self.val_ds
        loader = DataLoader(ds, self.val_bs, tokenizer=self.tokenizer, training=False,
                            seed=self.seed, lang_max_length=self.tokenizer.max_length,
                            drop_last=False)
        metric = STAMeanAveragePrecision(top_k=5)
        loss_agg: dict = {}
        loss_batches = 0
        results: dict = {}
        bucket = self.aug.eval_bucket()
        cap_inexact_images = 0  # pre-NMS cap exactness diagnostic (roi_heads)
        for batch in loader:
            dets, losses = self.eval_loss_step(self._device_batch(batch), self.val_loss_w)
            dets = map_tensors(dets, lambda t: t.cpu().numpy())
            if "pre_nms_missed" in dets:
                kept = dets["valid"].sum(axis=1)
                cap_inexact_images += int(
                    ((dets["pre_nms_missed"] > 0) & (kept < dets["valid"].shape[1])).sum())
            for k, v in losses.items():
                loss_agg[k] = loss_agg.get(k, 0.0) + float(v)
            loss_batches += 1
            t = batch["targets"]
            for i in range(len(batch["uids"])):
                v = dets["valid"][i]
                ry, rx = batch["orig_hw"][i][0] / bucket[0], batch["orig_hw"][i][1] / bucket[1]
                preds = {
                    "boxes": dets["boxes"][i][v] * np.array([rx, ry, rx, ry]),
                    "scores": dets["scores"][i][v],
                    "nouns": dets["nouns"][i][v],
                    "verbs": dets["verbs"][i][v],
                    "ttcs": dets["ttcs"][i][v],
                }
                gv = t["valid"][i]
                sy = batch["orig_hw"][i][0] / batch["image"].shape[1]
                sx = batch["orig_hw"][i][1] / batch["image"].shape[2]
                metric.add(preds, {
                    "boxes": t["boxes"][i][gv] * np.array([sx, sy, sx, sy]),
                    "nouns": t["nouns"][i][gv],
                    "verbs": t["verbs"][i][gv],
                    "ttcs": t["ttcs"][i][gv],
                })
            results.update(detections_to_results(dets, batch["uids"], batch["orig_hw"], bucket,
                                                 last_noun_idx=self.num_nouns - 1))
        loader.close()
        if cap_inexact_images:
            log.warning("pre-NMS candidate cap exactness precondition broke on %d image(s); "
                        "raise RoIConfig.pre_nms_candidates to make the postprocess exact",
                        cap_inexact_images)
        metrics = {f"{name}_{source}": v
                   for name, v in zip(metric.get_short_names(), metric.evaluate())}
        for k, v in loss_agg.items():
            metrics[f"{source}_{k}"] = v / max(loss_batches, 1)
        log.info("epoch %d %s: %s", epoch, source, {k: round(v, 3) for k, v in metrics.items()})
        path = None
        if export:
            path = write_result_json(
                results, os.path.join(self.run_dir, "results", f"{source}_epoch{epoch}.json"),
                epoch=epoch)
        return EvalResult(metrics=metrics, result_json_path=path)

    # ------------------------------------------------------------------ fit
    def fit(self, epochs: int | None = None, resume_from: str | None = None, wandb_run=None,
            wandb_module=None, log_checkpoints: bool = True):
        """Train for ``epochs`` (run.epochs by default), validating every
        ``val_every`` epochs; a checkpoint an epoch, a line of
        ``history.jsonl`` an epoch, and ``checkpoints/best.json`` for the
        best monitored metric. wandb logging is not ported yet."""
        if wandb_run is not None:
            raise NotImplementedError("wandb logging is not ported yet")
        epochs = epochs if epochs is not None else self.run["epochs"]
        self.ensure_state(resume_from)
        val_every = max(int(self.run.get("val_every", 1.0)), 1)
        best = None
        for epoch in range(epochs):
            record = {"epoch": epoch, **self.train_epoch(epoch)}
            if (epoch + 1) % val_every == 0:
                record.update(self.evaluate(epoch).metrics)
            ckpt_path = self.ckpt.save(epoch, self.model, self.state, metrics=record)
            mval = record.get(self.monitor)
            if mval is not None and (best is None or mval > best["value"]):
                best = {"metric": self.monitor, "value": float(mval), "epoch": epoch,
                        "path": ckpt_path}
                with open(os.path.join(self.ckpt.dir, "best.json"), "w") as fp:
                    json.dump(best, fp, indent=1)
            self.history.append(record)
            with open(os.path.join(self.run_dir, "history.jsonl"), "a") as fp:
                fp.write(json.dumps(record) + "\n")
        return self.history
