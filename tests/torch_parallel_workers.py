"""Rank processes of the port's data-parallel and tensor-parallel CPU tests
(``tests/test_torch_parallel.py``, ``tests/test_torch_tensor_parallel.py``):
each joins a gloo process group of ``world`` ranks on ``localhost``, runs
its part and writes what it saw to ``out/rank<r>.pt``. No JAX here: the
ranks import torch and the port only.
"""

import os

import numpy as np
import torch

H, W = 64, 80
N_TRAIN, N_VAL, LANG = 8, 5, 16


def spawn(fn, world: int, *args) -> None:
    """Run ``fn(rank, world, port, *args)`` in ``world`` fresh processes."""
    spawn_groups(fn, (world,), *args)


def spawn_groups(fn, worlds, *args, meanwhile=None):
    """Run ``fn(rank, world, port, *args)`` in a group of ``world`` fresh
    processes for each of ``worlds``, the groups at the same time, and
    ``meanwhile()`` here while they run; returns its result."""
    import torch.multiprocessing as mp

    from transfusion_torch.parallel.mesh import free_port

    groups = [mp.spawn(fn, args=(w, free_port(), *args), nprocs=w, join=False) for w in worlds]
    try:
        result = meanwhile() if meanwhile is not None else None
    finally:
        for ctx in groups:
            while not ctx.join():
                pass
    return result


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


def tiny_data(n_train: int = N_TRAIN, n_val: int = N_VAL):
    return _chip_smoke().trainer_data(np, seed=4, hw=(H, W), n_train=n_train, n_val=n_val,
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
    """One epoch of ``tiny_run_config`` (train, validation with 64
    test-time proposals an image, checkpoint) with the model in float64
    (``_tp_trainer``'s ``f64``), data-parallel in ``out/dp`` and fully
    sharded in ``out/fsdp``."""
    from transfusion_torch.parallel import mesh

    _join(rank, world, port)
    try:
        for mode in ("dp", "fsdp"):
            trainer = _tp_trainer(tiny_run_config(mode == "fsdp"), os.path.join(out, mode),
                                  device="cpu", data=tiny_data(), f64=True)
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


# ------------------------------------------------- the model axis (tests/test_torch_tensor_parallel.py)
TP_MIN_DIM = 16  # tiny widths clear it, as JAX's tests/test_mesh_trainer.py lowers it
# One train step: a second step's losses move with discrete choices (the RoI
# sampler's near-ties on random weights) that f32 sums in another order flip.
# One validation batch of 2 images (the plain RoIAlign over every proposal is
# the CPU run's largest cost).
TP_TRAIN, TP_VAL = 4, 2


def tp_run_config(fsdp: bool = False) -> dict:
    cfg = tiny_run_config(fsdp)
    cfg["run"]["val_bs"] = TP_VAL
    return cfg


def tp_data():
    return tiny_data(TP_TRAIN, TP_VAL)


def record_draws(records: list):
    """Wrap ``DropoutRNG.keep`` so each draw appends (the global tensor's
    shape, dtype, a digest of the mask generator's state before it): equal
    records draw equal masks. Returns the undo."""
    import hashlib

    from transfusion_torch.models.text_encoder import DropoutRNG

    keep = DropoutRNG.keep

    def wrapped(self, x, rate, shard=None):
        shape = list(x.shape)
        if self.rows is not None:
            start, stop, total = self.rows
            shape[0] = shape[0] // (stop - start) * total
        if shard is not None:
            shape[shard[0] % x.ndim] *= shard[2]
        digest = hashlib.sha1(self.masks.get_state().numpy().tobytes()).hexdigest()
        records.append((tuple(shape), str(x.dtype), digest))
        return keep(self, x, rate, shard)

    DropoutRNG.keep = wrapped
    return lambda: setattr(DropoutRNG, "keep", keep)


def few_proposals(build):
    """``build`` (a ``build_transfusion_config``) whose configurations keep
    128 / 64 proposals an image at test time: the CPU's plain RoIAlign over
    the RPN's 1,000 is most of a tiny model's evaluation."""
    from dataclasses import replace

    def config(*a, **k):
        cfg = build(*a, **k)
        rpn = replace(cfg.detector.rpn, pre_nms_top_n_test=128, post_nms_top_n_test=64)
        return replace(cfg, detector=replace(cfg.detector, rpn=rpn))

    return config


def _tp_trainer(*args, f64: bool = False, **kwargs):
    """An ``EgoNaoTrainer`` whose RPN keeps 64 proposals an image at test
    time (``few_proposals``) and, under ``f64``, whose model computes in
    float64 (parameters and activations; the optimizer's moments and the
    LayerNorms' statistics stay f32): the parity runs' arithmetic without
    f32 rounding, which this tiny random-weight model amplifies."""
    from transfusion_torch.runner import trainer as T

    build, model = T.build_transfusion_config, T.TransFusion
    config = few_proposals(lambda *a, **k: build(*a, **({**k, "dtype": torch.float64} if f64 else k)))

    def f64_model(*a, **k):
        torch.set_default_dtype(torch.float64)
        try:
            return model(*a, **k).double()
        finally:
            torch.set_default_dtype(torch.float32)

    T.build_transfusion_config = config
    if f64:
        T.TransFusion = f64_model
    try:
        return T.EgoNaoTrainer(*args, **kwargs)
    finally:
        T.build_transfusion_config, T.TransFusion = build, model


def tp_fit(cfg: dict, run_dir: str, mesh_=None, resume: str | None = None,
           f64: bool = False, keep_ckpt: bool = False) -> dict:
    """``fit(1)`` of ``cfg`` on ``mesh_`` (the tiny data, ``TP_MIN_DIM``;
    ``f64``: in float64), or a resume from checkpoint ``resume`` and its
    evaluation: the whole state, history, result JSON, dropout draws and
    collective counts. The checkpoint (hundreds of MB: the trunk's widths
    are ResNet-50's) is deleted unless ``keep_ckpt``."""
    from transfusion_torch.parallel import tensor_parallel as tp
    from transfusion_torch.parallel.mesh import rank

    trainer = _tp_trainer(cfg, run_dir, device="cpu", data=tp_data(), mesh=mesh_,
                          tp_min_dim=TP_MIN_DIM, f64=f64)
    trainer.ensure_state(resume_from=resume)
    init = {k: v.detach().clone() for k, v in trainer.model.named_parameters()}
    draws: list = []
    undo = record_draws(draws)
    for k in tp.COLLECTIVES:
        tp.COLLECTIVES[k] = 0
    try:
        if resume:
            metrics = trainer.evaluate(0).metrics
        else:
            trainer.fit(1)
            metrics = trainer.history[0]
    finally:
        undo()
    record = {"model": {k: v.detach().clone()
                        for k, v in trainer.sharding.full_model_state(trainer.model).items()},
              "opt_state": trainer.sharding.full_state(trainer.state.opt_state),
              "metrics": metrics, "draws": draws, "collectives": dict(tp.COLLECTIVES),
              "init": init if trainer.model.tensor_parallel is None else None,
              "local_numel": sum(p.numel() for p in trainer.model.parameters()),
              "local_opt_numel": sum(v.numel() for v in trainer.state.opt_state["mu"].values())}
    path = os.path.join(run_dir, "results", "val_epoch0.json")
    if os.path.isfile(path):
        import json

        record["results"] = json.load(open(path))
    if not keep_ckpt and rank() == 0:
        import shutil

        shutil.rmtree(os.path.join(run_dir, "checkpoints"), ignore_errors=True)
    return record


def tp_rank(rank: int, world: int, port: int, payload: dict, out: str) -> None:
    """One rank of the model-axis checks, all in one process group: at
    ``world`` 2 (mesh 1 x 2) the golden tiny eval, ``fit(1)`` of
    ``tiny_run_config`` in f32 and in f64 and a resume of a one-rank
    checkpoint; at ``world`` 4 (mesh 2 x 2, FSDP) ``fit(1)`` in f64."""
    from transfusion_torch.models.detector import detections_from_outputs
    from transfusion_torch.models.transfusion import TransFusion
    from transfusion_torch.parallel import mesh
    from transfusion_torch.parallel import tensor_parallel as tp
    from transfusion_torch.weights import shard_state_dict

    _join(rank, world, port)
    torch.set_num_threads(1)  # six ranks at once beside the pytest workers
    try:
        m = mesh.make_mesh(model=2)
        record = {}
        if world == 2:
            mesh.use_mesh(m)
            model = TransFusion(payload["golden_cfg"], device="cpu", mesh=m, tp_min_dim=TP_MIN_DIM)
            model.load_state_dict(shard_state_dict(payload["golden_sd"], m, TP_MIN_DIM))
            tp.COLLECTIVES["all_reduce"] = 0
            with torch.no_grad():
                dets = detections_from_outputs(model(payload["golden_batch"]),
                                               payload["golden_cfg"].detector,
                                               noun_verb_frequencies=payload["freqs"])
            record["golden"] = {"dets": dets, "all_reduce": tp.COLLECTIVES["all_reduce"],
                                "split": len(model.tensor_parallel.split)}
            record["fit"] = tp_fit(tp_run_config(), os.path.join(out, "tp2"), m, keep_ckpt=True)
            record["fit64"] = tp_fit(tp_run_config(), os.path.join(out, "tp2_f64"), m, f64=True)
            record["resume"] = tp_fit(tp_run_config(), os.path.join(out, "tp2_resume"), m,
                                      resume=payload["one_ckpt"])
        else:
            record["fit64"] = tp_fit(tp_run_config(fsdp=True), os.path.join(out, "tp2x2"), m,
                                     f64=True)
        torch.save(record, os.path.join(out, f"tp{world}_rank{rank}.pt"))
    finally:
        mesh.destroy_process_group()
