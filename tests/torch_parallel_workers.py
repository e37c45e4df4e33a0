"""Rank processes of the port's data-parallel CPU tests
(``tests/test_torch_parallel.py``): each joins a gloo process group of
``world`` ranks on ``localhost``, runs its part and writes what it saw to
``out/rank<r>.pt``. No JAX here: the ranks import torch and the port only.
"""

import os

import numpy as np
import torch

H, W = 64, 80
N_TRAIN, N_VAL, LANG = 8, 5, 16


def spawn(fn, world: int, *args) -> None:
    """Run ``fn(rank, world, port, *args)`` in ``world`` fresh processes."""
    import torch.multiprocessing as mp

    from transfusion_torch.parallel.mesh import free_port

    mp.spawn(fn, args=(world, free_port(), *args), nprocs=world, join=True)


def _join(rank: int, world: int, port: int) -> None:
    from transfusion_torch.parallel import mesh

    torch.set_num_threads(2)
    mesh.init_process_group(rank, world, f"tcp://localhost:{port}", device_type="cpu")


def _chip_smoke():
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if repo not in sys.path:
        sys.path.insert(0, repo)
    import chip_smoke

    return chip_smoke


def tiny_run_config(fsdp: bool = False) -> dict:
    """chip_smoke.py's flagship run config cut to a tiny f32 model at 64x80
    (stages (1, 1, 1, 1), fusion at level 3 with 32-dim tokens, the tiny
    MiniLM) with trainable BN and the whole trunk training from epoch 0,
    its dropouts on, a global batch of 4 and clipping at 4."""
    cfg = _chip_smoke().flagship_run_config()
    cfg["aug"]["resize_spec"] = [[H], [W]]
    m = cfg["model"]
    m.update(train_ep=0, trainable_layers=5, representation_size=64, stage_sizes=[1, 1, 1, 1],
             batch_norm={"use": True, "momentum": 0.1})
    m["rcnn_kwargs"].update(box_batch_size_per_image=16, rpn_batch_size_per_image=32)
    run = cfg["run"]
    run.update(precision=32, train_bs=4, val_bs=4, grad_clip=4.0, fsdp=fsdp)
    run["narration_embeds"]["args"].update(model_v="minilm-tiny", out_mlp=32)
    fus = run["narr_fusion"]
    fus.update(fpn_features=[3], patch_h=[1], patch_w=[1])
    fus["args"].update(input_f_size=32, num_layers=[1], num_heads=2)
    run["optimizer"]["lr"] = 1e-3
    return cfg


def tiny_data():
    return _chip_smoke().trainer_data(np, seed=4, hw=(H, W), n_train=N_TRAIN, n_val=N_VAL,
                                      lang=LANG)


def trainer_record(trainer) -> dict:
    """What the tests compare of a trainer after ``fit``: parameters,
    running averages, the whole optimizer state, history and result JSON."""
    import json

    full = trainer.sharding.full_state(trainer.state.opt_state)
    path = os.path.join(trainer.run_dir, "results", "val_epoch0.json")
    return {"model": {k: v.detach().clone() for k, v in trainer.model.state_dict().items()},
            "opt_state": full, "history": trainer.history,
            "results": json.load(open(path)) if os.path.isfile(path) else None}


def fit_rank(rank: int, world: int, port: int, out: str) -> None:
    """One epoch of ``tiny_run_config`` (train, validation, checkpoint),
    data-parallel in ``out/dp`` and fully sharded in ``out/fsdp``."""
    from transfusion_torch.parallel import mesh
    from transfusion_torch.runner.trainer import EgoNaoTrainer

    _join(rank, world, port)
    try:
        for mode in ("dp", "fsdp"):
            trainer = EgoNaoTrainer(tiny_run_config(mode == "fsdp"), os.path.join(out, mode),
                                    device="cpu", data=tiny_data())
            trainer.fit(1)
            record = trainer_record(trainer)
            record["local_opt_numel"] = sum(v.numel()
                                            for v in trainer.state.opt_state["mu"].values())
            torch.save(record, os.path.join(out, mode, f"rank{rank}.pt"))
    finally:
        mesh.destroy_process_group()


def jax_step_rank(rank: int, world: int, port: int, payload: dict, out: str) -> None:
    """The port's train step on this rank's slice of ``payload``'s batch,
    from its JAX-made weights, once with every parameter replicated and
    once fully sharded."""
    from transfusion_torch.models.transfusion import TransFusion
    from transfusion_torch.parallel import mesh
    from transfusion_torch.parallel.fsdp import Sharding
    from transfusion_torch.train.losses import build_class_weights
    from transfusion_torch.train.optim import make_optimizer
    from transfusion_torch.train.step import LossConfig, TrainState, make_train_step
    from transfusion_torch.weights import state_dict_from_jax

    _join(rank, world, port)
    try:
        record = {}
        for fsdp in (False, True):
            model = TransFusion(payload["tcfg"], device="cpu")
            model.load_state_dict(state_dict_from_jax(payload["params"],
                                                      batch_stats=payload["batch_stats"]))
            tx, _ = make_optimizer(payload["opt"], payload["sched"], steps_per_epoch=1,
                                   grad_clip=4.0)
            sharding = Sharding(model, fsdp, fsdp_min_size=payload["fsdp_min_size"])
            state = TrainState(step=0, opt_state=tx.init(sharding.views()))
            step = make_train_step(model, tx, LossConfig(**payload["loss_kw"]),
                                   *build_class_weights(*payload["class_w"], 1.0, True, True),
                                   sharding)
            metrics = step(state, mesh.shard_batch(payload["batch"]), payload["loss_w"],
                           payload["mult"], payload["draws"])
            record["fsdp" if fsdp else "dp"] = {
                "metrics": {k: float(v) for k, v in metrics.items()},
                "model": {k: v.detach().clone() for k, v in model.state_dict().items()},
                "sharded": len(sharding.sharded),
            }
        torch.save(record, os.path.join(out, f"rank{rank}.pt"))
    finally:
        mesh.destroy_process_group()
