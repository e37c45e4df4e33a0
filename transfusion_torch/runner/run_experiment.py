"""Config-driven experiment launcher (CLI; port of
``transfusion_tpu/runner/run_experiment.py``):

    python -m transfusion_torch.runner.run_experiment \
        --config $CODE/runner/nao/configs/ego_nao_res50_ego4dv2.yml \
        [--debug] [--run-val] [--run-test] [--resume-from PATH|ID[:vN]|URL] \
        [--epochs N] [--run-dir DIR] [--device cuda|cpu] [--devices N] \
        [--distributed] [--mesh-model M] [--mesh-fsdp] [--wandb-entity E] \
        [--wandb-project P] [--do-not-log-checkpoints] [--skip-ssl-verification]

The reference YAMLs run unmodified (``${CODE}``/``${DATA}``/``${RUNS}``
interpolation included); the JSONL history and the challenge JSONs in the
run directory are the record. It runs on one device, ``cuda`` unless
``--device`` names another, or data-parallel on several: ``--devices N``
starts N local ranks itself (one a card, or N gloo processes under
``--device cpu``), ``--distributed`` (or ``TRANSFUSION_DISTRIBUTED=1``)
joins the process group torchrun describes in the environment
(``torchrun --nproc-per-node N -m transfusion_torch.runner.run_experiment
--distributed ...``). ``--mesh-model M`` factors the N ranks as (N / M, M),
as the JAX CLI does: the weights the JAX rule splits are split over the M
ranks of each data row (tensor parallelism). ``--mesh-fsdp`` shards the
large parameters' optimizer state over the data axis. wandb is optional:
where the package imports (and the run is not a debug run), rank 0 logs the
config, each epoch's record, plot, checkpoint and result JSON to
``--wandb-project`` / ``--wandb-entity``; ``--resume-from`` also takes a
wandb run id ``id[:vN]`` or run URL and downloads its ``model-<id>``
artifact (``runner/wandb_resume.py``), which raises without wandb.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Run experiments.")
    p.add_argument("--config", type=str, required=True, help="run config YAML")
    p.add_argument("--debug", action="store_true", default=False,
                   help="reduced samples + small batch end-to-end check")
    p.add_argument("--resume-from", type=str, default="",
                   help="checkpoint directory, or wandb run id[:vN] / URL "
                        "(downloads the model artifact)")
    p.add_argument("--run-test", action="store_true", default=False)
    p.add_argument("--run-val", action="store_true", default=False)
    p.add_argument("--epochs", type=int, default=None, help="override run.epochs")
    p.add_argument("--run-dir", type=str, default=None,
                   help="output directory (default: $RUNS/<experiment>/<timestamp>)")
    p.add_argument("--device", type=str, default="cuda", help="torch device (default cuda)")
    p.add_argument("--devices", type=int, default=None,
                   help="data-parallel over N local ranks (one a card; gloo processes on cpu)")
    p.add_argument("--mesh-fsdp", action="store_true", default=False,
                   help="fully-sharded data parallelism over the ranks")
    p.add_argument("--distributed", action="store_true", default=False,
                   help="join the process group torchrun describes (TRANSFUSION_DISTRIBUTED=1)")
    p.add_argument("--mesh-model", type=int, default=1,
                   help="tensor parallelism: M ranks of a data row split the model's weights")
    p.add_argument("--skip-ssl-verification", action="store_true", default=False,
                   help="disable SSL certificate verification for wandb "
                        "artifact downloads (reference run_experiment.py:307-310)")
    p.add_argument("--do-not-log-checkpoints", action="store_true", default=False,
                   help="skip uploading per-epoch checkpoint artifacts to wandb")
    p.add_argument("--wandb-entity", default=None)
    p.add_argument("--wandb-project", default="transfusion-tpu")
    return p


def make_run_dir(experiment: str, override: str | None) -> str:
    if override:
        os.makedirs(override, exist_ok=True)
        return override
    base = os.path.expandvars("$RUNS") if os.environ.get("RUNS") else "runs"
    run_dir = os.path.join(base, experiment, time.strftime("%Y%m%d_%H%M%S"))
    os.makedirs(run_dir, exist_ok=True)
    return run_dir


def maybe_wandb(config: dict, args) -> object | None:
    """A wandb run, or None where wandb does not import or the run is a
    debug run (unless ``force_wandb_logging``)."""
    try:
        import wandb
    except ImportError:
        return None
    if config.get("debug") and not config.get("force_wandb_logging"):
        return None
    return wandb.init(project=args.wandb_project, entity=args.wandb_entity, config=dict(config))


def _rank_main(rank: int, argv, world: int, port: int, device_type: str):
    """One rank of ``--devices N``: join the group, then run the CLI."""
    from transfusion_torch.parallel import mesh

    os.environ["LOCAL_RANK"] = str(rank)
    if device_type == "cpu":
        import torch

        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))  # ranks share the host
    mesh.init_process_group(rank, world, f"tcp://localhost:{port}", device_type=device_type)
    try:
        _run(get_parser().parse_args(argv))
    finally:
        mesh.destroy_process_group()


def main(argv=None):
    from transfusion_torch.parallel import mesh

    args = get_parser().parse_args(argv)
    if mesh.distributed_requested(args.distributed):
        mesh.init_process_group(device_type=args.device.split(":")[0])
        try:
            return _run(args)
        finally:
            mesh.destroy_process_group()
    if args.devices and args.devices > 1:
        import torch.multiprocessing as mp

        argv = sys.argv[1:] if argv is None else list(argv)
        mp.spawn(_rank_main, args=(argv, args.devices, mesh.free_port(), args.device.split(":")[0]),
                 nprocs=args.devices, join=True)
        return None
    return _run(args)


def _shared_run_dir(experiment: str, override: str | None) -> str:
    """Rank 0's run directory, the same on every rank."""
    from transfusion_torch.parallel import mesh

    run_dir = make_run_dir(experiment, override) if mesh.rank() == 0 else None
    return mesh.allgather_pyobj(run_dir)[0]


def _run(args):
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    if args.skip_ssl_verification:
        # The reference's mechanism (run_experiment.py:307-310): clusters with
        # intercepting proxies otherwise fail the wandb artifact fetch.
        import ssl

        ssl._create_default_https_context = ssl._create_unverified_context

    from transfusion_torch.config import derive_config, load_config
    from transfusion_torch.parallel.mesh import allgather_pyobj, make_mesh, rank
    from transfusion_torch.runner.trainer import EgoNaoTrainer
    from transfusion_torch.runner.wandb_resume import resolve_resume

    config = load_config(args.config)
    if config.get("experiment") != "egonao":
        raise NotImplementedError(f"experiment {config.get('experiment')!r} (only egonao is wired)")
    config = derive_config(config, {"debug": args.debug, "resume_from": args.resume_from})
    if args.run_test:
        config["run"]["run_test"] = True
    if args.run_val:
        config["run"]["run_val"] = True

    run_dir = _shared_run_dir(config["experiment"], args.run_dir)
    if rank() == 0:
        with open(os.path.join(run_dir, "config.json"), "w") as fp:
            json.dump(dict(config), fp, default=str, indent=1)
    # ${run_dir}/run.log mirrors everything the root logger emits (rank r > 0:
    # run.rank<r>.log).
    fh = logging.FileHandler(os.path.join(run_dir, "run.log" if rank() == 0
                                          else f"run.rank{rank()}.log"))
    fh.setFormatter(logging.Formatter("%(asctime)s %(name)s %(message)s"))
    logging.getLogger().addHandler(fh)
    logging.info("run dir: %s", run_dir)

    wb = None
    try:
        # A local path, or a wandb id[:vN] / URL whose artifact rank 0
        # downloads (run_experiment.py:188-253), before anything is built.
        resume = resolve_resume(args.resume_from or None, run_dir, args.wandb_entity,
                                args.wandb_project) if rank() == 0 else None
        resume = allgather_pyobj(resume)[0]
        wb = maybe_wandb(config, args) if rank() == 0 else None
        if wb is not None:
            # Config artifact at run start (run_experiment.py:312-327).
            import wandb

            art = wandb.Artifact(f"config-{wb.id}", type="config")
            art.add_file(os.path.join(run_dir, "config.json"))
            wb.log_artifact(art)
        trainer = EgoNaoTrainer(config, run_dir, debug=config["debug"], device=args.device,
                                mesh=make_mesh(model=args.mesh_model), fsdp=args.mesh_fsdp)
        if config["run"].get("run_test") or config["run"].get("run_val"):
            trainer.ensure_state(resume)
            test = bool(config["run"].get("run_test"))
            result = trainer.evaluate(0, dataset=trainer.test_ds if test else None,
                                      source="test" if test else "val")
            if rank() == 0:
                print(json.dumps(result.metrics, indent=1))
        else:
            history = trainer.fit(epochs=args.epochs, resume_from=resume, wandb_run=wb,
                                  log_checkpoints=not args.do_not_log_checkpoints)
            if rank() == 0:
                print(json.dumps(history[-1] if history else {}, indent=1))
    finally:
        logging.getLogger().removeHandler(fh)
        fh.close()
        if wb is not None:
            wb.finish()


if __name__ == "__main__":
    main()
