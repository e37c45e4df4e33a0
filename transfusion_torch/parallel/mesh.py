"""Process groups, the data axis and the FSDP sharding rule (port of
``transfusion_tpu/parallel/mesh.py``).

The reference's only distribution strategy is data parallelism (DDP); the
JAX package runs it as a ``data`` mesh axis under ``jit``, where XLA
reduces gradients and BatchNorm statistics over the global batch. The port
runs one process a device in a ``torch.distributed`` process group (NCCL
for CUDA, gloo for the CPU): each rank takes a contiguous slice of the
global batch (:func:`shard_batch`), and the train step reduces what JAX's
global program reduces: the loss normalisers, the BatchNorm statistics and
the gradients (``train/step.py``). A :class:`Mesh` keeps the JAX shape
``{"data", "model"}``; a model axis above 1 (tensor parallelism) is not
ported and raises.

Without a process group :func:`world_size` is 1 and :func:`rank` 0, as
``jax.process_count()`` and ``jax.process_index()`` are in one process, and
every collective here is the identity.
"""

from __future__ import annotations

import os
import socket
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

FSDP_MIN_SIZE = 2 ** 16


def tensor_parallel_refusal(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what}: tensor parallelism (the mesh's model axis, "
                               "_is_model_shardable / constrain_activation) is not ported yet")


@dataclass(frozen=True)
class Mesh:
    """The device mesh's shape: ``data`` ranks (one a device), ``model`` 1."""

    data: int = 1
    model: int = 1

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.model}


def make_mesh(data: int | None = None, model: int = 1, devices=None) -> Mesh:
    """The mesh over ``devices`` (default: one a rank of the process group):
    ``data`` defaults to all of them. A ``model`` axis above 1 raises."""
    if model > 1:
        raise tensor_parallel_refusal(f"make_mesh(model={model})")
    n = len(devices) if devices is not None else world_size()
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    return Mesh(data, model)


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if initialized() else 1


def rank() -> int:
    return dist.get_rank() if initialized() else 0


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", rank()))


def distributed_requested(flag: bool = False) -> bool:
    """``--distributed`` or ``TRANSFUSION_DISTRIBUTED=1`` (the JAX CLI's switch)."""
    return bool(flag) or os.environ.get("TRANSFUSION_DISTRIBUTED") == "1"


def init_process_group(rank_: int | None = None, world: int | None = None,
                       init_method: str | None = None, backend: str | None = None,
                       device_type: str = "cuda") -> None:
    """Join the process group: from explicit ``(rank_, world, init_method)``
    (a ``tcp://host:port`` address), else from torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``). The
    backend is NCCL for ``device_type`` cuda and gloo for the CPU unless
    named; under NCCL the rank's device is ``cuda:LOCAL_RANK``. A second
    call is a no-op."""
    if initialized():
        return
    if rank_ is None:
        rank_, world, init_method = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]), "env://"
    backend = backend or ("nccl" if device_type == "cuda" else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank_)) % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, rank=rank_, world_size=world)


def destroy_process_group() -> None:
    if initialized():
        dist.destroy_process_group()


def free_port() -> int:
    """A free TCP port on ``localhost`` for a group's ``tcp://`` address."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def round_to_data_axis(batch_size: int, data: int) -> int:
    """A global batch size rounded up to a multiple of the data axis."""
    return -(-max(int(batch_size), 1) // data) * data


def batch_rows(local_batch: int) -> tuple[int, int, int]:
    """(start, stop, total): this rank's rows of the global batch when every
    rank holds ``local_batch`` of them."""
    r, w = rank(), world_size()
    return r * local_batch, (r + 1) * local_batch, w * local_batch


def shard_batch(batch, rank_: int | None = None, world: int | None = None):
    """A rank's contiguous slice of a global batch: every array or tensor
    leaf with a leading dimension (the global batch, a multiple of
    ``world``) keeps rows ``rank * B / world`` up to the next rank's; other
    leaves (``image_hw``) are kept."""
    r = rank() if rank_ is None else rank_
    w = world_size() if world is None else world

    def cut(x):
        if isinstance(x, dict):
            return {k: cut(v) for k, v in x.items()}
        if isinstance(x, (np.ndarray, torch.Tensor)) and x.ndim >= 1:
            if x.shape[0] % w:
                raise ValueError(f"batch of {x.shape[0]} rows does not split over {w} ranks")
            b = x.shape[0] // w
            return x[r * b:(r + 1) * b]
        return x

    return cut(batch)


def allgather_pyobj(obj, process_count: int | None = None) -> list:
    """Every rank's picklable ``obj``, ordered by rank; ``[obj]`` without a
    collective in one process."""
    n = process_count if process_count is not None else world_size()
    if n == 1:
        return [obj]
    out = [None] * n
    dist.all_gather_object(out, obj)
    return out


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks (a new tensor; ``t`` itself in one
    process). Not differentiable: for the loss normalisers and counts."""
    if world_size() == 1:
        return t
    out = t.detach().clone()
    dist.all_reduce(out)
    return out


def all_reduce_sum_(tensors: list, bucket_numel: int = 1 << 25) -> None:
    """Sum each tensor over the ranks in place, through flat buckets of at
    most ``bucket_numel`` elements a dtype (one collective a bucket)."""
    if world_size() == 1 or not tensors:
        return
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault((t.dtype, t.device), []).append(t)
    for group in by_dtype.values():
        bucket, size = [], 0
        for t in group + [None]:
            if t is not None and (not bucket or size + t.numel() <= bucket_numel):
                bucket.append(t)
                size += t.numel()
                continue
            flat = torch.cat([b.reshape(-1) for b in bucket])
            dist.all_reduce(flat)
            off = 0
            for b in bucket:
                b.copy_(flat[off:off + b.numel()].view_as(b))
                off += b.numel()
            if t is not None:
                bucket, size = [t], t.numel()


def param_shardings(named_shapes, data: int, fsdp: bool = False,
                    fsdp_min_size: int = FSDP_MIN_SIZE) -> dict:
    """{name: the dimension it is sharded on over the data axis, or None}
    for (name, shape) pairs: the JAX package's FSDP rule (:169-209) with no
    model axis. Under ``fsdp`` a parameter of at least ``fsdp_min_size``
    elements shards on its largest dimension divisible by ``data`` (the
    first of equals); smaller ones, and those with no such dimension, stay
    replicated, as do all without ``fsdp`` or with one rank."""
    out = {}
    for name, shape in named_shapes:
        shape = tuple(shape)
        dim = None
        if fsdp and data > 1 and int(np.prod(shape)) >= fsdp_min_size:
            cands = [d for d in range(len(shape)) if shape[d] % data == 0]
            if cands:
                dim = max(cands, key=lambda i: shape[i])
        out[name] = dim
    return out
