"""Reference checkpoint -> port checkpoint directory (the port's counterpart
of ``transfusion_tpu/tools/translate_checkpoint.py``).

The reference is a PyTorch model, and the port keeps its parameter names and
layouts, so no tensor is transposed or permuted here (the JAX tool's
OIHW -> HWIO, fc6 and fold-patch permutations exist only for flax). What is
left of the translation is the key surgery of ``rcnn_factory.py:85-108``:
the wrapper prefixes are stripped (``weights.strip_wrapper_prefixes``), a
plain stem is folded into a space-to-depth model's (``weights.
fold_plain_stem``), and the result is loaded into a port model built from
``--config`` with ``--num-nouns`` / ``--num-verbs`` classes, entries whose
name and shape match taken from the checkpoint and the rest kept at the
seeded init (``train.checkpoint.tolerant_merge``).

    python -m transfusion_torch.tools.translate_checkpoint \\
        --checkpoint translated_ego4dv2.pth --config <run yml> \\
        --num-nouns 88 --num-verbs 75 --out <dir>

writes ``<dir>/state.pt`` (``{"model": state dict}``, what ``model.
pretrained: <dir>`` and ``EgoNaoTrainer._load_pretrained_weights`` read)
and the JAX tool's ``<dir>.provenance.json`` sidecar, which makes the
trainer refuse the weights under a hash-fallback tokenizer. The model is
built on the host: the translation moves tensors and runs no kernel.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from transfusion_torch.train.checkpoint import CheckpointManager, tolerant_merge
from transfusion_torch.weights import fold_plain_stem, strip_wrapper_prefixes


def translate_reference_checkpoint(state_dict: dict, model: torch.nn.Module) -> tuple[dict, dict]:
    """(the model's state dict filled from ``state_dict``, report). The
    report counts the translated tensors and lists the source keys no
    target takes, the target keys no source fills, and the shape
    mismatches (a partial checkpoint loads cleanly)."""
    sd = strip_wrapper_prefixes(state_dict.get("state_dict", state_dict))
    fresh = model.state_dict()
    if "backbone.body.stem_s2d.weight" in fresh:
        sd = fold_plain_stem(sd)
    sd = {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}
    mismatch = [k for k in fresh if k in sd and tuple(sd[k].shape) != tuple(fresh[k].shape)]
    merged = tolerant_merge(fresh, sd)
    report = {
        "translated": sum(k in sd and k not in mismatch for k in fresh),
        "unmatched_source": sorted(k for k in sd if k not in fresh),
        "missing_target": sorted(k for k in fresh if k not in sd),
        "shape_mismatch": mismatch,
    }
    return merged, report


def write_provenance(out: str, checkpoint: str) -> str:
    """The sidecar ``<out>.provenance.json`` (JAX translate_checkpoint.py:548-553)."""
    path = os.path.abspath(out).rstrip("/") + ".provenance.json"
    with open(path, "w") as fp:
        json.dump({"source": "torch_translation", "pretrained_language_tower": True,
                   "checkpoint": os.path.basename(checkpoint)}, fp)
    return path


def main(argv=None):
    from transfusion_torch.config import derive_config, load_config
    from transfusion_torch.models.transfusion import TransFusion, build_transfusion_config
    from transfusion_torch.weights import init_random_

    parser = argparse.ArgumentParser()
    parser.add_argument("--checkpoint", required=True, help="torch .pth/.ckpt file")
    parser.add_argument("--config", required=True, help="reference run config YAML")
    parser.add_argument("--num-nouns", type=int, required=True)
    parser.add_argument("--num-verbs", type=int, required=True)
    parser.add_argument("--out", required=True, help="output checkpoint directory")
    args = parser.parse_args(argv)

    cfg = build_transfusion_config(derive_config(load_config(args.config)), args.num_nouns,
                                   args.num_verbs)
    model = init_random_(TransFusion(cfg, device="cpu"), seed=0)
    sd = torch.load(args.checkpoint, map_location="cpu", weights_only=False)
    merged, report = translate_reference_checkpoint(sd, model)
    os.makedirs(args.out, exist_ok=True)
    torch.save({"model": merged}, os.path.join(args.out, CheckpointManager.STATE))
    # Restoring pretrained (vocab-aligned) tower weights under a hash-fallback
    # tokenizer would silently produce garbage token ids: the trainer checks
    # this marker and fails loudly.
    write_provenance(args.out, args.checkpoint)
    summary = {
        "translated": report["translated"],
        "unmatched_source": len(report["unmatched_source"]),
        "missing_target": len(report["missing_target"]),
        "shape_mismatch": report["shape_mismatch"][:10],
    }
    print(json.dumps(summary, indent=1))
    if report["unmatched_source"]:
        print("unmatched (first 20):", report["unmatched_source"][:20])
    return summary


if __name__ == "__main__":
    main()
