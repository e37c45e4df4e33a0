"""Weights for the port: carried across from a JAX param tree, or made at
random from a seed.

:func:`state_dict_from_jax` is the inverse of
``transfusion_tpu/tools/translate_checkpoint.py::translate_reference_checkpoint``:
it takes a TransFusion param tree (numpy leaves, built with the plain 7x7
stem) of any fusion family and option, language tower and TTC head and
returns the port's state dict under the reference torch names (JAX's
module names where the reference has none: see
:mod:`transfusion_torch.models.transfusion`). The translator has no
mapping for the transformer TTC head or the sbert type embeddings, so those
weights cross from JAX to the port only. It
undoes the translator's four layout changes: HWIO -> OIHW convs, the fc6
column order (y, x, c) -> (c, y, x), the back-projection fold order
(ph, pw, C) -> (C, ph, pw) (rows and bias), and the split q/k/v projections
-> the packed ``in_proj_weight``/``in_proj_bias``.
:func:`radam_state_from_jax` carries an optax RAdam state (its moments
through the same mapping) into the port's optimizer state.
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


def _rcnn(rcnn: dict, out: dict):
    bb = rcnn["backbone"]
    if "stem_s2d" in bb:
        raise ValueError("params use the space-to-depth stem; build them with s2d_stem=False")
    for name, node in bb.items():
        if name == "stem":
            out["backbone.body.conv1.weight"] = _conv(node["conv"]["kernel"])
            for k, v in node["bn"].items():
                out[f"backbone.body.bn1.{_BN[k]}"] = np.asarray(v)
            continue
        m = re.fullmatch(r"layer(\d)_(\d+)", name)
        if not m:
            raise KeyError(f"unexpected backbone param {name}")
        base = f"backbone.body.layer{m.group(1)}.{m.group(2)}"
        for sub, cn in node.items():
            if sub == "downsample":
                out[f"{base}.downsample.0.weight"] = _conv(cn["conv"]["kernel"])
                for k, v in cn["bn"].items():
                    out[f"{base}.downsample.1.{_BN[k]}"] = np.asarray(v)
            else:
                i = sub.removeprefix("conv")
                out[f"{base}.conv{i}.weight"] = _conv(cn["conv"]["kernel"])
                for k, v in cn["bn"].items():
                    out[f"{base}.bn{i}.{_BN[k]}"] = np.asarray(v)
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
            base = f"{enc}.{stream}_layers.{j}"
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


def state_dict_from_jax(params: dict, fpn_features=None) -> dict:
    """JAX TransFusion params (``variables["params"]`` or the variables
    themselves, numpy or jax leaves) -> the port's state dict (f32 tensors).
    ``fpn_features`` orders the ``fusion_<lvl>`` and ``vis_fusion_<lvl>``
    subtrees (default: by lvl)."""
    params = params.get("params", params)
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
    encodings and CLS token, type embeddings normal(1 / init_div), zero
    ``zero`` positions (the JAX inits), 0.02-normal token and position
    embeddings of the towers, 0.01-normal RoI predictors."""
    gen = torch.Generator().manual_seed(seed)
    for name, t in list(model.named_parameters()) + list(model.named_buffers()):
        if name.endswith(("running_mean", "table")):
            val = torch.zeros(t.shape) if name.endswith("running_mean") else None
        elif name.endswith("running_var"):
            val = torch.ones(t.shape)
        elif name.endswith("pos.pos_embedding"):
            learned = model.get_submodule(name.removesuffix(".pos_embedding")).kind == "learned"
            val = torch.randn(t.shape, generator=gen) if learned else torch.zeros(t.shape)
        elif name.endswith(("kind_embedding", "_enc", "cls_token")):
            val = torch.randn(t.shape, generator=gen)
        elif ".type_embeddings." in name:
            div = model.get_submodule(name.split(".type_embeddings.")[0]).type_embedding_init_div
            val = torch.randn(t.shape, generator=gen) / div
        elif name.endswith("relative_attention_bias.weight"):
            val = torch.randn(t.shape, generator=gen)
        elif ("embeddings" in name or name.endswith(("wte.weight", "wpe.weight", "shared.weight"))) \
                and t.dim() == 2:
            val = torch.randn(t.shape, generator=gen) * 0.02
        elif t.dim() == 1:
            is_scale = name.endswith("weight") and ("norm" in name.lower() or ".bn" in name
                                                    or "downsample.1" in name or ".ln." in name
                                                    or re.search(r"\.ln_(\d|f)\.", name))
            val = torch.ones(t.shape) if is_scale else torch.zeros(t.shape)
        else:
            # GPT-2's Conv1D weights are [in, out].
            fan_in = t.shape[0] if ".transformer.h." in name else int(np.prod(t.shape[1:]))
            std = 0.01 if re.search(r"roi_heads\.(noun|verb|box_regressor|ttc)", name) else fan_in ** -0.5
            val = torch.randn(t.shape, generator=gen) * std
        if val is not None:
            t.copy_(val.to(t.dtype))
    return model
