"""The epoch freeze rules of the trainer (port of
``transfusion_tpu/runner/trainer.py:114-191``, only
:func:`unfreeze_multipliers` and :func:`backbone_stop_grad_stages` so far),
over the port's ``named_parameters()``.

The JAX parameter paths map onto the port's reference names: ``backbone``
(the ResNet body; JAX keeps the FPN outside it) is ``backbone.body.*``, its
stem ``backbone.body.conv1``, stage ``layerN`` ``backbone.body.layerN.*``;
``narr_encoder`` is ``narr_pooling_layer.*`` with BERT layer ``layer_i`` at
``...encoder.layer.i.``; the RoI heads (``box_head``/``predictors``) are
``roi_heads.*``. JAX holds the frozen BatchNorm vectors as parameters, the
port as buffers: with these multipliers a frozen backbone moves in neither.
"""

from __future__ import annotations

import re


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
    ``train_ep``, its last ``finetune_layers`` BERT layers;
    ``freeze_backbone_at`` leaves only the RoI heads training."""
    if str(model_cfg.get("type", "res50")).startswith("mobilenet"):
        raise NotImplementedError("the MobileNet backbone is not ported yet")
    if text_encoder != "sbert":
        raise NotImplementedError(f"text encoder {text_encoder!r} is not ported yet")
    train_ep = model_cfg.get("train_ep", -1)
    trainable_layers = model_cfg.get("trainable_layers", 0)
    backbone_on = train_ep != -1 and epoch >= train_ep
    # layers_to_train = [layer4, layer3, layer2, layer1, stem][:trainable_layers]
    unfrozen_units = {f"layer{4 - i}" for i in range(min(trainable_layers, 4))}
    if trainable_layers == 5:
        unfrozen_units |= {"conv1", "bn1"}  # the stem
    narr_on = narr_train_ep != -1 and epoch >= narr_train_ep
    unfrozen_bert = {num_bert_layers - 1 - i for i in range(narr_finetune_layers)}
    roi_only = freeze_backbone_at != -1 and epoch >= freeze_backbone_at

    def assign(name: str) -> float:
        if roi_only:
            return 1.0 if name.startswith("roi_heads.") else 0.0
        if name.startswith("backbone.body."):
            return 1.0 if backbone_on and name.split(".")[2] in unfrozen_units else 0.0
        if name.startswith("narr_pooling_layer."):
            if ".out_mlp." in name:
                return 1.0
            m = re.search(r"\.encoder\.layer\.(\d+)\.", name)
            return 1.0 if narr_on and m and int(m.group(1)) in unfrozen_bert else 0.0
        return 1.0

    return {name: assign(name) for name, _ in named_params}
