"""Weights for the port: carried across from a JAX param tree, or made at
random from a seed.

:func:`state_dict_from_jax` is the inverse of
``transfusion_tpu/tools/translate_checkpoint.py::translate_reference_checkpoint``:
it takes a TransFusion param tree (numpy leaves) of any backbone (ResNet
with the plain or the space-to-depth stem, MobileNetV3-Large, dual-stream),
fusion family and option, language tower and TTC head and returns the
port's state dict under the reference torch names (JAX's module names
where the reference has none: see :mod:`transfusion_torch.models.transfusion`,
``models/mobilenet.py``, ``models/dual_stream.py``). The translator has no
mapping for the transformer TTC head or the sbert type embeddings, so those
weights cross from JAX to the port only. It
undoes the translator's four layout changes: HWIO -> OIHW convs, the fc6
column order (y, x, c) -> (c, y, x), the back-projection fold order
(ph, pw, C) -> (C, ph, pw) (rows and bias), and the split q/k/v projections
-> the packed ``in_proj_weight``/``in_proj_bias``.
:func:`radam_state_from_jax` carries an optax RAdam state (its moments
through the same mapping) into the port's optimizer state. The legacy
heatmap family's models cross with :func:`resnet_nao_state_dict_from_jax`,
:func:`scnn_state_dict_from_jax` and
:func:`heatmap_fusion_state_dict_from_jax`.
"""

from __future__ import annotations

import re

import numpy as np
import torch

_BN = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}
_BERT = "narr_pooling_layer.encoder.0.auto_model."


def _conv(k):
    return np.asarray(k).transpose(3, 2, 0, 1)  # HWIO -> OIHW


def _lin(k):
    return np.asarray(k).T


def _dense(out: dict, name: str, node: dict):
    out[f"{name}.weight"] = _lin(node["kernel"])
    if "bias" in node:
        out[f"{name}.bias"] = np.asarray(node["bias"])


def _conv_norm(out: dict, conv: str, norm: str, node: dict):
    """A JAX ConvNorm / ConvBN ({conv: {kernel}, bn: {...}}) at the port's
    conv and norm names."""
    out[f"{conv}.weight"] = _conv(node["conv"]["kernel"])
    for k, v in node["bn"].items():
        out[f"{norm}.{_BN[k]}"] = np.asarray(v)


def _bottleneck(base: str, node: dict, out: dict):
    """A (dual) bottleneck's convs, norms and fusion projection."""
    for sub, cn in node.items():
        if sub == "downsample":
            _conv_norm(out, f"{base}.downsample.0", f"{base}.downsample.1", cn)
        elif sub == "fuse":
            out[f"{base}.fuse.proj.weight"] = _conv(cn["proj"]["kernel"])
        else:
            i = sub.removeprefix("conv")
            _conv_norm(out, f"{base}.conv{i}", f"{base}.bn{i}", cn)


def _inverted_residual(base: str, node: dict, out: dict):
    """A JAX InvertedResidual (expand, depthwise, se, project, each where
    present) at ``{base}.block.{j}``."""
    parts = [p for p in ("expand", "depthwise", "se", "project") if p in node]
    for j, part in enumerate(parts):
        sub = f"{base}.block.{j}"
        if part == "se":
            for fc in ("fc1", "fc2"):
                out[f"{sub}.{fc}.weight"] = _conv(node["se"][fc]["kernel"])
                out[f"{sub}.{fc}.bias"] = np.asarray(node["se"][fc]["bias"])
        else:
            _conv_norm(out, f"{sub}.0", f"{sub}.1", node[part])


def _mobilenet(bb: dict, out: dict, body: str):
    """MobileNetV3Features: the stem at ``{body}.0``, block ``block_i`` at
    ``{body}.{i + 1}.block.{j}`` (expand, depthwise, se, project in that
    order, each where present). Blocks 13 and 14 feed no returned level; the
    port does not build them and their params are skipped."""
    from transfusion_torch.models.mobilenet import BUILT_BLOCKS

    for name, node in bb.items():
        if name == "stem":
            _conv_norm(out, f"{body}.0.0", f"{body}.0.1", node)
            continue
        m = re.fullmatch(r"block_(\d+)", name)
        if not m:
            raise KeyError(f"unexpected MobileNet param {name}")
        i = int(m.group(1))
        if i < BUILT_BLOCKS:
            _inverted_residual(f"{body}.{i + 1}", node, out)


def _backbone(bb: dict, out: dict, body: str = "backbone.body"):
    """The backbone's params (and batch stats, merged in) under ``body``:
    a ResNet (plain ``stem`` or ``stem_s2d`` + ``stem_bn``), a MobileNet
    (``block_i``) or a dual-stream ResNet (``flow_stem``, ``flow{s}_*`` and
    each block's ``fuse``)."""
    if "block_0" in bb:
        _mobilenet(bb, out, body)
        return
    for name, node in bb.items():
        if name in ("stem", "flow_stem"):
            pre = "flow_" if name == "flow_stem" else ""
            _conv_norm(out, f"{body}.{pre}conv1", f"{body}.{pre}bn1", node)
            continue
        if name == "stem_s2d":
            out[f"{body}.stem_s2d.weight"] = _conv(node["kernel"])
            continue
        if name == "stem_bn":
            for k, v in node.items():
                out[f"{body}.bn1.{_BN[k]}"] = np.asarray(v)
            continue
        m = re.fullmatch(r"flow(\d)_(conv\d|down)", name)
        if m:
            base = f"{body}.flow_layer{m.group(1)}"
            if m.group(2) == "down":
                _conv_norm(out, f"{base}.downsample.0", f"{base}.downsample.1", node)
            else:
                i = m.group(2).removeprefix("conv")
                _conv_norm(out, f"{base}.conv{i}", f"{base}.bn{i}", node)
            continue
        m = re.fullmatch(r"layer(\d)_(\d+)", name)
        if not m:
            raise KeyError(f"unexpected backbone param {name}")
        _bottleneck(f"{body}.layer{m.group(1)}.{m.group(2)}", node, out)


def fold_plain_stem(state_dict: dict) -> dict:
    """A detector state dict with a plain stem (``backbone.body.conv1.weight``,
    a reference checkpoint's) made loadable into a space-to-depth model: the
    conv folded into ``backbone.body.stem_s2d.weight``
    (``resnet.fold_stem_weight``), ``bn1`` kept, as ``translate_checkpoint.py``
    folds a reference stem for JAX's s2d target. A state dict without the
    plain stem comes back as it is."""
    from transfusion_torch.models.resnet import fold_stem_weight

    key = "backbone.body.conv1.weight"
    if key not in state_dict:
        return state_dict
    out = {k: v for k, v in state_dict.items() if k != key}
    out["backbone.body.stem_s2d.weight"] = fold_stem_weight(torch.as_tensor(state_dict[key]))
    return out


def resnet_state_dict_from_jax(params: dict, batch_stats: dict | None = None) -> dict:
    """A JAX backbone body's params (``ResNet``, ``MobileNetV3Features`` or
    ``DualStreamResNet``; under trainable BN with its ``batch_stats``) ->
    the state dict of the port's body (f32 tensors)."""
    out: dict = {}
    _backbone(_merge(params, batch_stats or {}), out, body="")
    return _tensors(out)


def _tensors(out: dict) -> dict:
    return {k.removeprefix("."): torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in out.items()}


def _nao_heads(params: dict, out: dict):
    """The heads JAX's ResnetNao, ScnnNao and HeatmapCrossFusion share:
    ``heatmap_head`` (two convs), ``dist_mlp`` and ``offset_stds``, the
    noun / verb / TTC Dense layers; the names are kept."""
    if "heatmap_head" in params:
        for c in ("conv1", "conv2"):
            node = params["heatmap_head"][c]
            out[f"heatmap_head.{c}.weight"] = _conv(node["kernel"])
            out[f"heatmap_head.{c}.bias"] = np.asarray(node["bias"])
    for name in ("dist_mlp", "noun_classifier", "verb_classifier", "ttc_predictor"):
        if name in params:
            _dense(out, name, params[name])
    if "offset_stds" in params:
        out["offset_stds"] = np.asarray(params["offset_stds"])


def resnet_nao_state_dict_from_jax(params: dict) -> dict:
    """A JAX ``ResnetNao``'s params -> the port's state dict: the trunk at
    torchvision's names (``conv1``, ``bn1``, ``layerN.i.*``, as the
    reference's ResnetWrapper holds a torchvision ResNet), the heads at
    JAX's."""
    out: dict = {}
    _backbone({k: v for k, v in params.items() if k == "stem" or re.fullmatch(r"layer\d_\d+", k)}, out,
              body="")
    _nao_heads(params, out)
    return _tensors(out)


def scnn_state_dict_from_jax(params: dict) -> dict:
    """A JAX ``ScnnNao``'s params -> the port's state dict (JAX's names;
    the reference's Fast-SCNN module is not in its tree): ConvBNs at
    ``.0`` / ``.1``, DSConv's ``depthwise`` / ``pointwise``, a stack's
    ``{name}_{b}`` at ``{name}.{b}`` with its parts at ``.block.{j}``."""
    out: dict = {}
    for name, node in params["trunk"].items():
        base = f"trunk.{name}"
        if name in ("ltd_ds1", "ltd_ds2"):
            for part in ("depthwise", "pointwise"):
                _conv_norm(out, f"{base}.{part}.0", f"{base}.{part}.1", node[part])
        elif name == "ppm":
            for sub, cn in node.items():
                _conv_norm(out, f"{base}.{sub}.0", f"{base}.{sub}.1", cn)
        elif m := re.fullmatch(r"(gfe\d)_(\d+)", name):
            _inverted_residual(f"trunk.{m.group(1)}.{m.group(2)}", node, out)
        else:
            _conv_norm(out, f"{base}.0", f"{base}.1", node)
    for name, node in params.items():
        if m := re.fullmatch(r"(bottleneck_\d)_(\d+)", name):
            _inverted_residual(f"{m.group(1)}.{m.group(2)}", node, out)
    _nao_heads(params, out)
    return _tensors(out)


def heatmap_fusion_state_dict_from_jax(params: dict) -> dict:
    """A JAX ``HeatmapCrossFusion``'s params -> the port's state dict: the
    kind embeddings at the reference's ``image_kind_embedding`` /
    ``lang_kind_embedding``, encoder layers at torch's
    ``TransformerEncoderLayer`` names (q/k/v packed into ``in_proj``), the
    QKV layers' and the rest at JAX's (``layer_i`` / ``vis_i`` /
    ``lang_i`` at ``layers.i`` / ``vis_layers.i`` / ``lang_layers.i``)."""
    out: dict = {"patch_to_token.weight": _conv(params["patch_to_token"]["kernel"])}
    for name in ("heatmap_token", "class_token"):
        if name in params:
            out[name] = np.asarray(params[name])
    out["image_kind_embedding"] = np.asarray(params["image_kind"])
    out["lang_kind_embedding"] = np.asarray(params["lang_kind"])
    _pos("", params, out)
    for j, lay in _layers("layer", params):
        _encoder_layer(f"layers.{j}", lay, out)
    for stream in ("vis", "lang"):
        for j, lay in _layers(stream, params):
            _qkv_layer(f"{stream}_layers.{j}", lay, out)
    for name, node in params["hmap_head"].items():
        _dense(out, f"hmap_head.{name}", node)
    if "class_post_linear" in params:
        _dense(out, "class_post_linear", params["class_post_linear"])
        _norm(out, "class_post_ln", params["class_post_ln"])
    _nao_heads(params, out)
    return _tensors(out)


def _rcnn(rcnn: dict, out: dict):
    _backbone(rcnn["backbone"], out)
    for name, node in rcnn["fpn"].items():
        kind, i = name.split("_")
        out[f"backbone.fpn.{kind}_blocks.{i}.weight"] = _conv(node["kernel"])
        out[f"backbone.fpn.{kind}_blocks.{i}.bias"] = np.asarray(node["bias"])
    for name, node in rcnn["rpn_head"].items():
        out[f"rpn.head.{name}.weight"] = _conv(node["kernel"])
        out[f"rpn.head.{name}.bias"] = np.asarray(node["bias"])
    fc6 = np.asarray(rcnn["box_head"]["fc6"]["kernel"])  # [(y, x, c), out]
    c = fc6.shape[0] // 49
    out["roi_heads.box_head.fc6.weight"] = (
        fc6.T.reshape(-1, 7, 7, c).transpose(0, 3, 1, 2).reshape(fc6.shape[1], -1))
    out["roi_heads.box_head.fc6.bias"] = np.asarray(rcnn["box_head"]["fc6"]["bias"])
    _dense(out, "roi_heads.box_head.fc7", rcnn["box_head"]["fc7"])
    for name, node in rcnn["predictors"].items():
        target = "box_regressor.1" if name == "box_regressor" else name
        _dense(out, f"roi_heads.{target}", node)


def _bert(bert: dict, out: dict):
    out[_BERT + "embeddings.word_embeddings.weight"] = np.asarray(bert["word_embeddings"]["embedding"])
    out[_BERT + "embeddings.position_embeddings.weight"] = np.asarray(bert["position_embeddings"])
    out[_BERT + "embeddings.token_type_embeddings.weight"] = np.asarray(bert["token_type_embeddings"])
    out[_BERT + "embeddings.LayerNorm.weight"] = np.asarray(bert["embeddings_norm"]["scale"])
    out[_BERT + "embeddings.LayerNorm.bias"] = np.asarray(bert["embeddings_norm"]["bias"])
    for name, node in bert.items():
        m = re.fullmatch(r"layer_(\d+)", name)
        if not m:
            continue
        base = f"{_BERT}encoder.layer.{m.group(1)}"
        for p in ("query", "key", "value"):
            _dense(out, f"{base}.attention.self.{p}", node["attention"][p])
        _dense(out, f"{base}.attention.output.dense", node["attention"]["output"])
        _dense(out, f"{base}.intermediate.dense", node["intermediate"])
        _dense(out, f"{base}.output.dense", node["output"])
        for src, dst in (("attention_norm", "attention.output.LayerNorm"),
                         ("output_norm", "output.LayerNorm")):
            out[f"{base}.{dst}.weight"] = np.asarray(node[src]["scale"])
            out[f"{base}.{dst}.bias"] = np.asarray(node[src]["bias"])


def _gpt2(tower: dict, out: dict):
    """GPT-2: the Conv1D weights keep flax's [in, out] kernel layout."""
    base = "narr_pooling_layer.encoder.transformer"
    out[f"{base}.wte.weight"] = np.asarray(tower["wte"]["embedding"])
    out[f"{base}.wpe.weight"] = np.asarray(tower["wpe"])
    _norm(out, f"{base}.ln_f", tower["ln_f"])
    for i, blk in _layers("h", tower):
        for ln in ("ln_1", "ln_2"):
            _norm(out, f"{base}.h.{i}.{ln}", blk[ln])
        for src, dst in (("c_attn", "attn.c_attn"), ("c_proj", "attn.c_proj"),
                         ("mlp_fc", "mlp.c_fc"), ("mlp_proj", "mlp.c_proj")):
            out[f"{base}.h.{i}.{dst}.weight"] = np.asarray(blk[src]["kernel"])
            out[f"{base}.h.{i}.{dst}.bias"] = np.asarray(blk[src]["bias"])


def _t5(tower: dict, out: dict):
    base = "narr_pooling_layer.encoder"
    out[f"{base}.shared.weight"] = np.asarray(tower["shared"]["embedding"])
    out[f"{base}.encoder.final_layer_norm.weight"] = np.asarray(tower["final_norm"]["scale"])
    for i, blk in _layers("block", tower):
        b = f"{base}.encoder.block.{i}.layer"
        for p in ("q", "k", "v", "o"):
            out[f"{b}.0.SelfAttention.{p}.weight"] = _lin(blk[p]["kernel"])
        if "relative_attention_bias" in blk:
            out[f"{b}.0.SelfAttention.relative_attention_bias.weight"] = np.asarray(
                blk["relative_attention_bias"])
        out[f"{b}.0.layer_norm.weight"] = np.asarray(blk["ln_attn"]["scale"])
        out[f"{b}.1.layer_norm.weight"] = np.asarray(blk["ln_ff"]["scale"])
        for p in ("wi", "wi_0", "wi_1", "wo"):
            if p in blk:
                out[f"{b}.1.DenseReluDense.{p}.weight"] = _lin(blk[p]["kernel"])


def _narr_encoder(narr: dict, out: dict):
    """The sbert tower (``bert``, type embeddings ``type_<name>``) or a
    GPT-2 / T5 tower (``encoder``), and ``out_mlp``."""
    if "bert" in narr:
        _bert(narr["bert"], out)
    elif "wte" in narr["encoder"]:
        _gpt2(narr["encoder"], out)
    else:
        _t5(narr["encoder"], out)
    for name, v in narr.items():
        if name.startswith("type_"):
            out[f"narr_pooling_layer.type_embeddings.{name.removeprefix('type_')}"] = np.asarray(v)
    if "out_mlp" in narr:
        _dense(out, "narr_pooling_layer.out_mlp", narr["out_mlp"])


def _ttc_head(node: dict, out: dict):
    """The transformer TTC head under JAX's names (no reference names)."""
    base = "ttc_hand_head"
    for name, v in node.items():
        if name.endswith("_enc") or name == "cls_token":
            out[f"{base}.{name}"] = np.asarray(v)
        elif name in ("object_feat_embedder", "ttc_out"):
            _dense(out, f"{base}.{name}", v)
        elif name.endswith("_embedder"):
            for fc in ("fc1", "fc2"):
                _dense(out, f"{base}.{name}.{fc}", v[fc])
    for j, lay in _layers("layer", node):
        _encoder_layer(f"{base}.layers.{j}", lay, out)


def _norm(out: dict, name: str, node: dict):
    out[f"{name}.weight"] = np.asarray(node["scale"])
    out[f"{name}.bias"] = np.asarray(node["bias"])


def _encoder_layer(base: str, lay: dict, out: dict):
    """A fusion EncoderLayer: q/k/v packed into torch's in_proj."""
    out[f"{base}.self_attn.in_proj_weight"] = np.concatenate(
        [_lin(lay[p]["kernel"]) for p in ("q_proj", "k_proj", "v_proj")], 0)
    out[f"{base}.self_attn.in_proj_bias"] = np.concatenate(
        [np.asarray(lay[p]["bias"]) for p in ("q_proj", "k_proj", "v_proj")], 0)
    for p in ("linear1", "linear2"):
        _dense(out, f"{base}.{p}", lay[p])
    _dense(out, f"{base}.self_attn.out_proj", lay["out_proj"])
    for p in ("norm1", "norm2"):
        _norm(out, f"{base}.{p}", lay[p])


def _layers(prefix: str, node: dict):
    """(index, subtree) of ``<prefix>_<i>`` children, in index order."""
    found = [(int(m.group(1)), v) for k, v in node.items() if (m := re.fullmatch(rf"{prefix}_(\d+)", k))]
    return sorted(found, key=lambda kv: kv[0])


def _pos(base: str, node: dict, out: dict):
    if "pos" in node:  # learned or zero positions
        out[f"{base}.pos.pos_embedding"] = np.asarray(node["pos"]["pos_embedding"])


def _fusion(i: int, level: dict, out: dict):
    ph, pw, c, d = np.asarray(level["patch_to_token"]["kernel"]).shape
    out[f"patches_to_token.{i}.weight"] = _conv(level["patch_to_token"]["kernel"])
    bp = np.asarray(level["back_proj"]["kernel"])  # [D, (ph, pw, C)]
    out[f"tokens_to_features.{i}.linear.weight"] = (
        bp.T.reshape(ph, pw, c, d).transpose(2, 0, 1, 3).reshape(c * ph * pw, d))
    out[f"tokens_to_features.{i}.linear.bias"] = (
        np.asarray(level["back_proj"]["bias"]).reshape(ph, pw, c).transpose(2, 0, 1).reshape(-1))
    enc = f"cross_fusion_encoders.{i}"
    if "encoder" in level:  # space_time
        st = level["encoder"]
        out[f"{enc}.encoder.image_kind_embedding"] = np.asarray(st["image_kind"])
        _pos(f"{enc}.encoder", st, out)
        if "final_norm" in st:
            _norm(out, f"{enc}.encoder.final_norm", st["final_norm"])
        for j, lay in _layers("layer", st):
            for part in ("spatial", "temporal"):
                _encoder_layer(f"{enc}.encoder.layers.{j}.{part}", lay[part], out)
        return
    out[f"{enc}.image_kind_embedding"] = np.asarray(level["image_kind"])
    out[f"{enc}.lang_kind_embedding"] = np.asarray(level["lang_kind"])
    _pos(enc, level, out)
    if "final_norm" in level:
        _norm(out, f"{enc}.final_norm_layer", level["final_norm"])
    for j, lay in _layers("layer", level):
        _encoder_layer(f"{enc}.t_encoder.layers.{j}", lay, out)
    for stream in ("vis", "lang"):  # asymmetric
        for j, lay in _layers(stream, level):
            _qkv_layer(f"{enc}.{stream}_layers.{j}", lay, out)


def _qkv_layer(base: str, lay: dict, out: dict):
    """A QKVEncoderLayer: its Dense layers and flax norms, names kept."""
    for p in ("q_proj", "k_proj", "v_proj", "out_proj", "linear1", "linear2"):
        _dense(out, f"{base}.{p}", lay[p])
    for p in ("norm1", "norm2"):
        _norm(out, f"{base}.{p}", lay[p])


def _vis_fusion(i: int, node: dict, out: dict):
    out[f"vis_fusion.{i}.proj.weight"] = _lin(node["proj"]["kernel"])
    _pos(f"vis_fusion.{i}", node, out)
    for j, lay in _layers("layer", node):
        _encoder_layer(f"vis_fusion.{i}.layers.{j}", lay, out)


def _lm_head(name: str, node: dict, out: dict):
    if "ln" in node:
        _norm(out, f"{name}.ln", node["ln"])
    for p in ("mlp_noun", "mlp_verb"):
        if p in node:
            _dense(out, f"{name}.{p}", node[p])


def _merge(into: dict, extra: dict) -> dict:
    """``into`` with ``extra``'s leaves added at their paths (copies of the
    dicts on the way)."""
    out = dict(into)
    for k, v in extra.items():
        out[k] = _merge(out.get(k, {}), v) if isinstance(v, dict) else v
    return out


def state_dict_from_jax(params: dict, fpn_features=None, batch_stats: dict | None = None) -> dict:
    """JAX TransFusion params (``variables["params"]`` or the variables
    themselves, numpy or jax leaves) -> the port's state dict (f32 tensors).
    ``fpn_features`` orders the ``fusion_<lvl>`` and ``vis_fusion_<lvl>``
    subtrees (default: by lvl). Under trainable BN the params hold each
    norm's ``scale`` / ``bias`` and ``batch_stats`` (``variables
    ["batch_stats"]``, taken from the variables when not given) its
    ``mean`` / ``var``: they become ``weight`` / ``bias`` /
    ``running_mean`` / ``running_var``, the variance as flax keeps it
    (biased)."""
    if batch_stats is None and "batch_stats" in params:
        batch_stats = params["batch_stats"]
    params = params.get("params", params)
    if batch_stats:
        params = _merge(params, batch_stats)
    params = {k: (dict(v) if isinstance(v, dict) else v) for k, v in params.items()}
    out: dict = {}
    _rcnn(params["rcnn"], out)
    if "narr_encoder" in params:
        _narr_encoder(params["narr_encoder"], out)
    if "ttc_hand_head" in params:
        _ttc_head(params["ttc_hand_head"], out)
    levels = sorted(int(k.split("_")[1]) for k in params if re.fullmatch(r"fusion_\d+", k))
    order = list(fpn_features) if fpn_features is not None else levels
    for i, lvl in enumerate(order):
        _fusion(i, params[f"fusion_{lvl}"], out)
        if f"vis_fusion_{lvl}" in params:
            _vis_fusion(i, params[f"vis_fusion_{lvl}"], out)
    for j, lay in _layers("shared_layer", params):
        _encoder_layer(f"shared_t_encoder.layers.{j}", lay, out)
    if "lm_layer" in params:
        _lm_head("lm_layer", params["lm_layer"], out)
    for j, node in _layers("lm_layer", params):
        _lm_head(f"lm_layers.{j}", node, out)
    known = re.compile(r"rcnn|narr_encoder|ttc_hand_head|lm_layer(_\d+)?|shared_layer_\d+|(vis_)?fusion_\d+")
    unknown = [k for k in params if not known.fullmatch(k)]
    if unknown:
        raise NotImplementedError(f"params not ported yet: {sorted(unknown)}")
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in out.items()}


def shard_state_dict(state_dict: dict, mesh, tp_min_dim: int = 256,
                     model_rank: int | None = None) -> dict:
    """A whole state dict (``state_dict_from_jax``'s, a checkpoint's) cut to
    the slices model rank ``model_rank`` (default: this process's) holds on
    ``mesh`` under the JAX rule (``parallel.mesh.param_shardings``); the
    state itself at a model axis of 1."""
    from transfusion_torch.parallel.tensor_parallel import tensor_parallel_for

    split = tensor_parallel_for({k: v.shape for k, v in state_dict.items()}, mesh, tp_min_dim,
                                model_rank)
    return state_dict if split is None else split.shard_state_dict(state_dict)


def strip_wrapper_prefixes(state_dict: dict) -> dict:
    """A reference checkpoint's names -> the port's (rcnn_factory.py:86-92
    key surgery plus the lightning 'model.' prefix; a copy of
    ``transfusion_tpu/tools/translate_checkpoint.py::strip_wrapper_prefixes``)."""
    out = {}
    for k, v in state_dict.items():
        k = k.replace("model.rcnn_model.rcnn_to_wrap.", "")
        k = k.replace("model.rcnn_model.", "")
        if k.startswith("model."):
            k = k[len("model."):]
        k = k.replace("rpn.rpn_wrap.", "rpn.")
        k = k.replace("roi_heads.roi_head_wrap.", "roi_heads.")
        out[k] = v
    return out


def _find_adam_state(node):
    """The ScaleByAdamState (count, mu, nu) inside an optax state tree."""
    if all(hasattr(node, a) for a in ("count", "mu", "nu")):
        return node
    if isinstance(node, (tuple, list)):
        for child in node:
            found = _find_adam_state(child)
            if found is not None:
                return found
    return None


def radam_state_from_jax(opt_state, param_names, fpn_features=None) -> dict:
    """An optax RAdam chain's state (numpy or jax leaves) -> the port's
    optimizer state {"count", "mu", "nu"} (:mod:`transfusion_torch.train.optim`)
    over ``param_names``. The moments go through the same layout changes as
    the parameters; moments of the JAX parameters that are buffers in the
    port (the frozen BatchNorm vectors) are dropped."""
    adam = _find_adam_state(opt_state)
    if adam is None:
        raise ValueError("no scale_by_radam state (count, mu, nu) in the optimizer state")
    names = list(param_names)
    out = {"count": int(np.asarray(adam.count))}
    for key in ("mu", "nu"):
        moments = state_dict_from_jax(getattr(adam, key), fpn_features)
        missing = [n for n in names if n not in moments]
        if missing:
            raise KeyError(f"optimizer state lacks parameters: {missing[:5]}")
        out[key] = {n: moments[n] for n in names}
    return out


@torch.no_grad()
def init_random_(model: torch.nn.Module, seed: int = 0) -> torch.nn.Module:
    """Seeded random weights, made on the host with a ``torch.Generator``
    and copied to the model's device: fan-in scaled normal weights, zero
    biases, identity frozen BN, LayerNorms and RMSNorms, unit-normal kind
    embeddings, learned positions, T5 position-bias tables and TTC-head
    encodings and CLS token, the heatmap fusion's heatmap and class tokens,
    ones for the multivar head's offset_stds, type embeddings normal(1 /
    init_div), zero
    ``zero`` positions (the JAX inits), 0.02-normal token and position
    embeddings of the towers, 0.01-normal RoI predictors. A model split over
    a model axis draws each whole tensor and keeps its slice, so every rank
    holds the one-rank model's values."""
    from transfusion_torch.models.resnet import FrozenBatchNorm2d
    from transfusion_torch.ops.batch_norm import BatchNorm

    gen = torch.Generator().manual_seed(seed)
    split = getattr(model, "tensor_parallel", None)
    # Norms whose names say nothing of it (MobileNet's ``{i}.block.{j}.1``,
    # the motion stem's ``flow_bn1``).
    bn_scales = {f"{n}.weight" for n, m in model.named_modules()
                 if isinstance(m, (FrozenBatchNorm2d, BatchNorm))}
    for name, t in list(model.named_parameters()) + list(model.named_buffers()):
        shape = split.whole_shapes.get(name, t.shape) if split is not None else t.shape
        if name.endswith(("running_mean", "table")):
            val = torch.zeros(shape) if name.endswith("running_mean") else None
        elif name.endswith(("running_var", "offset_stds")):
            val = torch.ones(shape)
        elif name.endswith("pos.pos_embedding"):
            learned = model.get_submodule(name.removesuffix(".pos_embedding")).kind == "learned"
            val = torch.randn(shape, generator=gen) if learned else torch.zeros(shape)
        elif name.endswith(("kind_embedding", "_enc", "cls_token", "heatmap_token", "class_token")):
            val = torch.randn(shape, generator=gen)
        elif ".type_embeddings." in name:
            div = model.get_submodule(name.split(".type_embeddings.")[0]).type_embedding_init_div
            val = torch.randn(shape, generator=gen) / div
        elif name.endswith("relative_attention_bias.weight"):
            val = torch.randn(shape, generator=gen)
        elif ("embeddings" in name or name.endswith(("wte.weight", "wpe.weight", "shared.weight"))) \
                and len(shape) == 2:
            val = torch.randn(shape, generator=gen) * 0.02
        elif len(shape) == 1:
            is_scale = name in bn_scales or name.endswith("weight") and (
                "norm" in name.lower() or ".bn" in name or "downsample.1" in name or ".ln." in name
                or re.search(r"\.ln_(\d|f)\.", name))
            val = torch.ones(shape) if is_scale else torch.zeros(shape)
        else:
            # GPT-2's Conv1D weights are [in, out].
            fan_in = shape[0] if ".transformer.h." in name else int(np.prod(shape[1:]))
            std = 0.01 if re.search(r"roi_heads\.(noun|verb|box_regressor|ttc)", name) else fan_in ** -0.5
            val = torch.randn(shape, generator=gen) * std
        if val is not None:
            t.copy_((val if split is None else split.shard(name, val)).to(t.dtype))
    return model
