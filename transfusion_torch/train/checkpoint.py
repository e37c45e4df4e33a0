"""Checkpoints and the reference's resume/transfer behaviours (port of
``transfusion_tpu/train/checkpoint.py`` over ``torch.save``).

Each epoch's checkpoint is a directory (``epoch_path``) holding one
``state.pt``: the model's state dict (with trainable BatchNorm's running
averages, the JAX state's ``batch_stats``), the optimizer state, the
``TrainState`` step and seed, the epoch and its metrics, every tensor on
the host. Under data parallelism rank 0 writes it and it holds the whole
(unsharded) state, so it restores at any number of ranks. ``latest`` in the checkpoint directory names the newest one. The
port reads its own checkpoints, not the JAX package's orbax ones.
``tolerant_merge`` and ``replace_heads`` work on state dicts with the JAX
package's semantics (its :103 and :137).
"""

from __future__ import annotations

import logging
import os
import re

import torch

from transfusion_torch.models.resnet import batch_stats
from transfusion_torch.train.step import TrainState

log = logging.getLogger("transfusion_torch")


def monitor_metric_name(criterion: dict) -> str:
    """ModelCheckpoint monitor selection (factories.py:36-59)."""
    if criterion.get("bbox") and criterion.get("noun") and criterion.get("verb") and criterion.get("ttc"):
        return "map_box_noun_verb_ttc_val"
    if criterion.get("bbox") and criterion.get("noun") and criterion.get("verb"):
        return "map_box_noun_verb_val"
    if criterion.get("bbox") and criterion.get("noun"):
        return "map_box_noun_val"
    raise NotImplementedError("unsupported criterion combination for checkpoint monitor")


def map_tensors(tree, fn):
    """``fn`` applied to every tensor of a nested dict (a state dict, the
    optimizer state, detections)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_tensors(v, fn) for k, v in tree.items()}
    return tree


class CheckpointManager:
    """Save every epoch (save_top_k=-1 semantics), keep a ``latest``
    pointer, restore by path or epoch."""

    STATE = "state.pt"

    def __init__(self, run_dir: str):
        self.dir = os.path.abspath(os.path.join(run_dir, "checkpoints"))
        os.makedirs(self.dir, exist_ok=True)

    def epoch_path(self, epoch: int) -> str:
        return os.path.join(self.dir, f"epoch_{epoch:04d}")

    def save(self, epoch: int, model, state: TrainState, metrics: dict | None = None) -> str:
        path = self.epoch_path(epoch)
        os.makedirs(path, exist_ok=True)
        host = lambda t: t.detach().cpu()  # noqa: E731
        torch.save({
            "model": map_tensors(dict(model.state_dict()), host),
            "opt_state": map_tensors(state.opt_state, host),
            "step": int(state.step), "seed": int(state.seed), "epoch": epoch,
            "metrics": {k: float(v) for k, v in (metrics or {}).items()},
        }, os.path.join(path, self.STATE))
        if metrics:
            with open(path + ".metrics", "w") as fp:
                fp.write(repr({k: float(v) for k, v in metrics.items()}))
        with open(os.path.join(self.dir, "latest"), "w") as fp:
            fp.write(os.path.basename(path))
        return path

    def latest_epoch(self) -> int | None:
        pointer = os.path.join(self.dir, "latest")
        if os.path.isfile(pointer):
            m = re.fullmatch(r"epoch_(\d+)", open(pointer).read().strip())
            if m:
                return int(m.group(1))
        eps = [int(m.group(1)) for n in os.listdir(self.dir)
               if (m := re.fullmatch(r"epoch_(\d+)", n))]
        return max(eps) if eps else None

    def restore(self, model, path: str | None = None, epoch: int | None = None,
                tolerant: bool = True) -> TrainState:
        """Load a checkpoint's parameters into ``model`` (through
        :func:`tolerant_merge` unless ``tolerant`` is False, which raises on
        drift) and return its TrainState, the optimizer state on the
        model's device."""
        if path is None:
            if epoch is None:
                epoch = self.latest_epoch()
            if epoch is None:
                raise FileNotFoundError(f"no checkpoints under {self.dir}")
            path = self.epoch_path(epoch)
        saved = torch.load(os.path.join(path, self.STATE), map_location="cpu", weights_only=True)
        sd = saved["model"]
        if tolerant:
            sd = tolerant_merge(model.state_dict(), sd)
        model.load_state_dict(sd, strict=True)
        dev = model.device
        return TrainState(step=saved["step"], seed=saved["seed"],
                          opt_state=map_tensors(saved["opt_state"], lambda t: t.to(dev)),
                          batch_stats=batch_stats(model))


def tolerant_merge(template: dict, restored: dict) -> dict:
    """Shape-drift-tolerant checkpoint merge (reference load_state_dict,
    ego_nao_trainer.py:57-82): entries whose name and shape match are taken
    from the checkpoint; any other mismatch or missing/extra name keeps the
    template and is logged."""
    out = {}
    for name, tmpl in template.items():
        got = restored.get(name)
        if got is None:
            log.warning("checkpoint missing %s; keeping fresh init", name)
            out[name] = tmpl
        elif tuple(got.shape) != tuple(tmpl.shape):
            log.warning("shape drift at %s: ckpt %s vs model %s; keeping fresh init", name,
                        tuple(got.shape), tuple(tmpl.shape))
            out[name] = tmpl
        else:
            out[name] = got
    return out


HEAD_KEYS = ("noun_classifier", "verb_classifier", "box_regressor")


def replace_heads(restored: dict, fresh: dict) -> dict:
    """Transfer-learning surgery: keep the restored trunk, take the freshly
    initialized classification/regression heads (run_experiment.py:417-435)."""
    return {k: fresh[k] if any(h in k for h in HEAD_KEYS) else v for k, v in restored.items()}
