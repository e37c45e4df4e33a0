#!/usr/bin/env python3
"""Time the train step of chip_smoke.py's fusion-option configurations with
their flax LayerNorms as the port runs them (``FlaxLayerNorm``: an f32 input
summed and normalised in f32, the output rounded to bf16) against the same
model with those norms casting their input to bf16 first
(``FusedLayerNorm``'s forward), on one CUDA card.

    python scripts/ab_fusion_norms.py [CONFIG ...]   (default: space_time)

CONFIG is a key of ``chip_smoke.FUSION_OPTIONS``. Each configuration is
built as the fusion-options phase builds it (flagship width and depth,
seeded weights, its batch and train step). The two variants take turns,
flax, cast, cast, flax, each a warm-up step and then STEPS steps timed on
the host clock to the end of their device work; then one step of each
under ``torch.profiler``: the self device time summed over every averaged
event (an op and the kernels it launches both count, so the sum is about
twice the device's busy time; it serves to compare the variants) and the
top events by device time. The card's name and power limit go with the
record, printed as one JSON line and written to
``chiprun_out/ab_fusion_norms.json``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import types

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 3
TOP = 8


def set_variant(torch, model, variant: str) -> int:
    """Bind each FlaxLayerNorm of ``model`` to the flax forward or to
    FusedLayerNorm's cast-first forward; returns how many were bound."""
    from transfusion_torch.ops.layer_norm import FlaxLayerNorm, FusedLayerNorm

    norms = [m for m in model.modules() if isinstance(m, FlaxLayerNorm)]
    for m in norms:
        if variant == "cast":
            m.forward = types.MethodType(FusedLayerNorm.forward, m)
        else:
            m.__dict__.pop("forward", None)
    return len(norms)


def device_profile(torch, fn) -> dict:
    """One call of ``fn`` under torch.profiler: self device ms summed over
    the averaged events (ops and kernels alike) and the TOP events."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))

    events = [e for e in prof.key_averages() if dev_us(e) > 0]
    events.sort(key=dev_us, reverse=True)
    return {"device_ms": sum(dev_us(e) for e in events) / 1e3,
            "top": [{"name": e.key[:90], "ms": dev_us(e) / 1e3, "calls": e.count} for e in events[:TOP]]}


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("ab_fusion_norms: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from transfusion_torch.models.transfusion import TransFusion, build_transfusion_config
    from transfusion_torch.weights import init_random_

    names = sys.argv[1:] or ["space_time"]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    batch = cs.fusion_option_batch(torch, np)
    record = {"card": smi, "steps": STEPS, "configs": {}}
    for name in names:
        run_cfg = cs.fusion_option_run_config(name)
        cfg = build_transfusion_config(run_cfg, 88, 75, dtype=torch.bfloat16)
        model = init_random_(TransFusion(cfg, device="cuda"), seed=0)
        step, state, lw, mult = cs.fusion_option_train_step(torch, model, cfg, run_cfg)
        rec = {"flax_norms": set_variant(torch, model, "flax"), "flax": [], "cast": []}
        for variant in ("flax", "cast", "cast", "flax"):
            set_variant(torch, model, variant)
            step(state, batch, lw, mult)
            torch.cuda.synchronize()
            for _ in range(STEPS):
                t0 = time.perf_counter()
                step(state, batch, lw, mult)
                torch.cuda.synchronize()
                rec[variant].append(time.perf_counter() - t0)
        for variant in ("flax", "cast"):
            set_variant(torch, model, variant)
            rec[f"{variant}_profile"] = device_profile(torch, lambda: step(state, batch, lw, mult))
        print(f"[{name}] step s flax {[round(t, 4) for t in rec['flax']]}, cast "
              f"{[round(t, 4) for t in rec['cast']]}; device ms flax "
              f"{rec['flax_profile']['device_ms']:.2f}, cast {rec['cast_profile']['device_ms']:.2f} ({smi})")
        record["configs"][name] = rec
        del model, step, state
        torch.cuda.empty_cache()
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "ab_fusion_norms.json"), "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
