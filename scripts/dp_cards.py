#!/usr/bin/env python3
"""Data-parallel training across cards: the flagship with trainable BN
(``chip_smoke.py::dp_run_config``) on every card of the host over NCCL,
one rank a card, B 8 a card, replicated and then fully sharded, beside one
card alone in the same call.

    python3 scripts/dp_cards.py [--ranks N] [--device cpu --tiny]

Each run is ``EgoNaoTrainer.fit(1)`` on seeded in-memory examples at
768x1024 (3 train steps, 1 validation batch). Prints, per run, each step's
seconds (the first also tunes cuDNN), the validation batch's, the peak
memory a rank and one all-reduce of the flagship's parameters in f32 over
the group, then one JSON line and the cards' names and power limits.
``--device cpu --tiny`` rehearses it with gloo processes on a tiny model.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402


def run_config(world: int, fsdp: bool, tiny: bool) -> dict:
    cfg = cs.dp_run_config(fsdp)
    cfg["run"]["train_bs"] = cfg["run"]["val_bs"] = cs.B * world
    if tiny:
        cfg["aug"]["resize_spec"] = [[64], [80]]
        cfg["model"].update(stage_sizes=[1, 1, 1, 1], representation_size=64)
        run = cfg["run"]
        run["narration_embeds"]["args"].update(model_v="minilm-tiny", out_mlp=32)
        run["narr_fusion"].update(fpn_features=[3], patch_h=[1], patch_w=[1])
        run["narr_fusion"]["args"].update(input_f_size=32, num_layers=[1], num_heads=2)
    return cfg


def fit(world: int, fsdp: bool, device: str, tiny: bool, run_dir: str) -> dict:
    """fit(1) at ``world`` ranks (the caller's group), B 8 a rank."""
    import numpy as np
    import torch

    from transfusion_torch.parallel import mesh
    from transfusion_torch.runner.trainer import EgoNaoTrainer

    hw = (64, 80) if tiny else (cs.H, cs.W)
    data = cs.trainer_data(np, hw=hw, n_train=3 * cs.B * world, n_val=cs.B * world)
    trainer = EgoNaoTrainer(run_config(world, fsdp, tiny), run_dir, device=device, data=data)
    train_s: list = []
    val_s: list = []
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    for name, times in (("train_step", train_s), ("eval_loss_step", val_s)):
        def timed(*args, _fn=getattr(trainer, name), _times=times, **kwargs):
            t0 = time.perf_counter()
            out = _fn(*args, **kwargs)
            sync()
            _times.append(time.perf_counter() - t0)
            return out
        setattr(trainer, name, timed)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    rec = trainer.fit(1)[0]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if device == "cuda" else None
    grads = [torch.randn_like(p) for p in trainer.model.parameters()]
    allreduce_s = None
    if world > 1:
        torch.distributed.barrier()
        t0 = time.perf_counter()
        mesh.all_reduce_sum_(grads)
        sync()
        allreduce_s = time.perf_counter() - t0
    losses = {k: v for k, v in rec.items() if k.startswith("train_") and k.endswith("loss")}
    return {"world": world, "fsdp": fsdp, "train_step_s": train_s, "val_batch_s": val_s,
            "peak_gib": peak, "allreduce_s": allreduce_s, "sharded": len(trainer.sharding.sharded),
            "numel": sum(g.numel() for g in grads), "losses": losses}


def rank_main(rank: int, world: int, port: int, device: str, tiny: bool, out: str) -> None:
    import torch

    from transfusion_torch.parallel import mesh

    os.environ["LOCAL_RANK"] = str(rank)
    if device == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    mesh.init_process_group(rank, world, f"tcp://localhost:{port}", device_type=device)
    try:
        recs = [fit(world, fsdp, device, tiny, os.path.join(out, f"run_{fsdp}")) for fsdp in (False, True)]
        if rank == 0:
            with open(os.path.join(out, "ranks.json"), "w") as f:
                json.dump(recs, f)
    finally:
        mesh.destroy_process_group()


def main() -> int:
    import shutil
    import tempfile

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ranks", type=int, default=None, help="ranks (default: every card)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--tiny", action="store_true", help="a tiny model at 64x80 (rehearsal)")
    args = p.parse_args()
    import torch
    import torch.multiprocessing as mp

    from transfusion_torch import kernels
    from transfusion_torch.parallel import mesh

    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("dp_cards: no CUDA device", file=sys.stderr)
            return 2
        kernels.library()  # built once, before the ranks load it
    world = args.ranks or (torch.cuda.device_count() if args.device == "cuda" else 2)
    work = tempfile.mkdtemp(prefix="dp_cards_")
    try:
        t0 = time.perf_counter()
        mp.spawn(rank_main, args=(world, mesh.free_port(), args.device, args.tiny, work),
                 nprocs=world, join=True)
        with open(os.path.join(work, "ranks.json")) as f:
            recs = json.load(f)
        log_s = time.perf_counter() - t0
        recs.append(fit(1, False, args.device, args.tiny, os.path.join(work, "one")))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for r in recs:
        print(f"world {r['world']} {'fsdp' if r['fsdp'] else 'replicated'}: step s "
              f"{[round(t, 4) for t in r['train_step_s']]}, val batch s "
              f"{[round(t, 4) for t in r['val_batch_s']]}, peak {r['peak_gib']} GiB, all-reduce of "
              f"{r['numel']} f32 {r['allreduce_s']} s, {r['sharded']} sharded tensors", flush=True)
    smi = ""
    if args.device == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"runs": recs, "ranks_s": log_s}))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
