"""wandb run-id / artifact resume resolution (port of
``transfusion_tpu/runner/wandb_resume.py``).

The reference resumes either from a local checkpoint path or from a wandb
run id ``id[:vN]`` / run URL, downloading the ``model-<id>:<vN>`` artifact
(``runner/run_experiment.py:188-253``). Here the same surface resolves to a
local checkpoint directory of the port (one ``state.pt``, as
``EgoNaoTrainer.fit`` uploads it); wandb is an optional dependency imported
only when an id is actually given, or injected as ``wandb_module``.
"""

from __future__ import annotations

import logging
import os

from transfusion_torch.train.checkpoint import CheckpointManager

log = logging.getLogger("transfusion_torch")


def is_wandb_ref(resume_from: str) -> bool:
    """Mirrors get_resume_run_info's dispatch (run_experiment.py:195-201):
    anything that exists locally or contains a '.' (and is not a URL) is a
    local path; URLs and bare ids go to wandb."""
    if not resume_from or os.path.exists(resume_from):
        return False
    low = resume_from.lower()
    if low.startswith(("http:", "https:")):
        return True
    return "." not in resume_from


def resolve_resume(resume_from: str | None, run_dir: str,
                   entity: str | None = None, project: str = "transfusion-tpu",
                   wandb_module=None) -> str | None:
    """Returns a local checkpoint path to restore from (or None).

    ``id``, ``id:vN`` and run URLs download the wandb model artifact into
    ``<run_dir>/checkpoints/wandb_<id>_<v>`` once and reuse it afterwards.
    ``wandb_module`` injects a stub for offline tests."""
    if not resume_from:
        return None
    if not is_wandb_ref(resume_from):
        return resume_from

    wandb = wandb_module
    if wandb is None:
        try:
            import wandb  # type: ignore[no-redef]
        except ImportError as e:
            raise RuntimeError(
                f"--resume-from {resume_from!r} is a wandb reference but wandb "
                "is not installed; pass a local checkpoint path instead"
            ) from e

    if resume_from.lower().startswith(("http:", "https:")):
        run_id = [p for p in resume_from.split("/") if p][-1]
        model_v = "latest"
    else:
        run_id, _, model_v = resume_from.partition(":")
        model_v = model_v or "latest"
    if "-" in run_id:
        raise ValueError("pass the wandb run ID or URL, not the run name (run_experiment.py:210)")

    target = os.path.join(run_dir, "checkpoints", f"wandb_{run_id}_{model_v}")
    if not os.path.isdir(target):
        api = wandb.Api()
        prefix = f"{entity}/{project}/" if entity else f"{project}/"
        artifact = api.artifact(f"{prefix}model-{run_id}:{model_v}")
        artifact.download(root=target)
        log.info("downloaded wandb artifact model-%s:%s -> %s", run_id, model_v, target)

    # A checkpoint is a directory holding state.pt; an artifact wrapping one
    # checkpoint directory resolves one level down.
    entries = sorted(os.listdir(target))
    if CheckpointManager.STATE in entries or not entries:
        return target
    only_dirs = [e for e in entries if os.path.isdir(os.path.join(target, e))]
    if len(only_dirs) == 1 and len(entries) == 1:
        return os.path.join(target, only_dirs[0])
    return target
