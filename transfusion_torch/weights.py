"""Weights for the port: carried across from a JAX param tree, or made at
random from a seed.

:func:`state_dict_from_jax` is the inverse of
``transfusion_tpu/tools/translate_checkpoint.py::translate_reference_checkpoint``:
it takes a TransFusion param tree (numpy leaves, built with the plain 7x7
stem) and returns the port's state dict under the reference torch names. It
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


def _fusion(i: int, level: dict, out: dict):
    ph, pw, c, d = np.asarray(level["patch_to_token"]["kernel"]).shape
    out[f"patches_to_token.{i}.weight"] = _conv(level["patch_to_token"]["kernel"])
    bp = np.asarray(level["back_proj"]["kernel"])  # [D, (ph, pw, C)]
    out[f"tokens_to_features.{i}.linear.weight"] = (
        bp.T.reshape(ph, pw, c, d).transpose(2, 0, 1, 3).reshape(c * ph * pw, d))
    out[f"tokens_to_features.{i}.linear.bias"] = (
        np.asarray(level["back_proj"]["bias"]).reshape(ph, pw, c).transpose(2, 0, 1).reshape(-1))
    enc = f"cross_fusion_encoders.{i}"
    out[f"{enc}.image_kind_embedding"] = np.asarray(level["image_kind"])
    out[f"{enc}.lang_kind_embedding"] = np.asarray(level["lang_kind"])
    out[f"{enc}.final_norm_layer.weight"] = np.asarray(level["final_norm"]["scale"])
    out[f"{enc}.final_norm_layer.bias"] = np.asarray(level["final_norm"]["bias"])
    for name, lay in level.items():
        m = re.fullmatch(r"layer_(\d+)", name)
        if not m:
            continue
        base = f"{enc}.t_encoder.layers.{m.group(1)}"
        out[f"{base}.self_attn.in_proj_weight"] = np.concatenate(
            [_lin(lay[p]["kernel"]) for p in ("q_proj", "k_proj", "v_proj")], 0)
        out[f"{base}.self_attn.in_proj_bias"] = np.concatenate(
            [np.asarray(lay[p]["bias"]) for p in ("q_proj", "k_proj", "v_proj")], 0)
        for p in ("linear1", "linear2"):
            _dense(out, f"{base}.{p}", lay[p])
        _dense(out, f"{base}.self_attn.out_proj", lay["out_proj"])
        for p in ("norm1", "norm2"):
            out[f"{base}.{p}.weight"] = np.asarray(lay[p]["scale"])
            out[f"{base}.{p}.bias"] = np.asarray(lay[p]["bias"])


def state_dict_from_jax(params: dict, fpn_features=None) -> dict:
    """JAX TransFusion params (``variables["params"]`` or the variables
    themselves, numpy or jax leaves) -> the port's state dict (f32 tensors).
    ``fpn_features`` orders the ``fusion_<lvl>`` subtrees (default: by lvl)."""
    params = params.get("params", params)
    params = {k: (dict(v) if isinstance(v, dict) else v) for k, v in params.items()}
    out: dict = {}
    _rcnn(params["rcnn"], out)
    narr = params.get("narr_encoder")
    if narr is not None:
        _bert(narr["bert"], out)
        if "out_mlp" in narr:
            _dense(out, "narr_pooling_layer.out_mlp", narr["out_mlp"])
    levels = sorted(int(k.split("_")[1]) for k in params if re.fullmatch(r"fusion_\d+", k))
    order = list(fpn_features) if fpn_features is not None else levels
    for i, lvl in enumerate(order):
        _fusion(i, params[f"fusion_{lvl}"], out)
    unknown = set(params) - {"rcnn", "narr_encoder"} - {f"fusion_{lvl}" for lvl in levels}
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
    biases, identity frozen BN and LayerNorms, unit-normal kind embeddings
    (the JAX init), 0.02-normal BERT embeddings, 0.01-normal RoI predictors."""
    gen = torch.Generator().manual_seed(seed)
    for name, t in list(model.named_parameters()) + list(model.named_buffers()):
        if name.endswith(("running_mean", "table")):
            val = torch.zeros(t.shape) if name.endswith("running_mean") else None
        elif name.endswith("running_var"):
            val = torch.ones(t.shape)
        elif name.endswith("kind_embedding"):
            val = torch.randn(t.shape, generator=gen)
        elif "embeddings" in name and t.dim() == 2:
            val = torch.randn(t.shape, generator=gen) * 0.02
        elif t.dim() == 1:
            is_scale = name.endswith("weight") and ("norm" in name.lower() or ".bn" in name
                                                    or "downsample.1" in name)
            val = torch.ones(t.shape) if is_scale else torch.zeros(t.shape)
        else:
            fan_in = int(np.prod(t.shape[1:]))
            std = 0.01 if re.search(r"roi_heads\.(noun|verb|box_regressor|ttc)", name) else fan_in ** -0.5
            val = torch.randn(t.shape, generator=gen) * std
        if val is not None:
            t.copy_(val.to(t.dtype))
    return model
