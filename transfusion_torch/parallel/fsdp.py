"""The train step's gradient reduction and parameter sharding over the data
axis: data parallelism (every parameter replicated) and fully-sharded data
parallelism (``param_shardings(fsdp=True)``, the JAX package's ZeRO-3 rule
at ``transfusion_tpu/parallel/mesh.py:169-209``).

The model keeps each parameter whole, so the forward and backward run as on
one rank. The gradients are then summed over the ranks: a replicated
parameter's by an all-reduce (flat buckets), a sharded one's by a
reduce-scatter onto this rank's shard, a slice of the parameter along the
rule's dimension. The optimizer sees :meth:`Sharding.views`: the whole
replicated parameters and the sharded ones' slices, so its moments,
clipping, weight decay and update of a sharded parameter live on the shard
alone (the moments of the sharded parameters take 1 / R of their memory on
each rank), and :meth:`Sharding.gather_` all-gathers the updated shards
back into the whole parameters for the next forward. Clipping's global norm
adds the shards' squared norms over the ranks (:meth:`Sharding.sq_norm`).
Checkpoints hold the unsharded optimizer state (:meth:`Sharding.full_state`)
so a run saved at R ranks resumes at any count (:meth:`Sharding.shard_state`).

Stock DDP is not used: it expects a gradient for every parameter that
requires one, but the trunk behind the freeze schedule's tape cut gets none
and the set changes at the unfreeze epoch; it averages where the port's
losses are already normalised over the global batch and must be summed; and
one reduction after the backward over the parameters that train this epoch
(the 0/1 multipliers) moves no byte for the frozen ones.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from transfusion_torch.parallel.mesh import (FSDP_MIN_SIZE, all_reduce_sum_, global_sum,
                                             param_shardings, rank, world_size)


class Sharding:
    """How the train step holds ``model``'s parameters over the data axis:
    replicated (``fsdp`` False, or one rank) or sharded by the FSDP rule."""

    def __init__(self, model, fsdp: bool = False, fsdp_min_size: int = FSDP_MIN_SIZE):
        self.params = dict(model.named_parameters())
        self.world, self.rank = world_size(), rank()
        self.dims = param_shardings(((k, p.shape) for k, p in self.params.items()), self.world,
                                    fsdp, fsdp_min_size)
        self.sharded = [k for k, d in self.dims.items() if d is not None]

    def shard(self, name: str, t):
        """This rank's slice of a whole tensor shaped as parameter ``name``
        (``t`` itself for a replicated one)."""
        d = self.dims.get(name)
        if d is None:
            return t
        n = t.shape[d] // self.world
        return t.narrow(d, self.rank * n, n)

    def views(self) -> dict:
        """{name: the tensor the optimizer updates}: views into the
        parameters, whole or this rank's shard."""
        return {k: self.shard(k, p) for k, p in self.params.items()}

    def reduce_grads(self, grads: dict, active=None) -> dict:
        """Sum ``grads`` over the ranks: whole for the replicated names, onto
        this rank's shard for the sharded ones. Names outside ``active``
        (frozen this epoch) are not reduced; a sharded one gets its local
        slice. Replicated gradients are summed in place."""
        active = set(grads) if active is None else set(active)
        all_reduce_sum_([g for k, g in grads.items() if k in active and self.dims[k] is None])
        out = dict(grads)
        for k in self.sharded:
            g = grads[k]
            if k not in active:
                out[k] = self.shard(k, g)
                continue
            d = self.dims[k]
            full = g.movedim(d, 0).contiguous()
            part = torch.empty((full.shape[0] // self.world, *full.shape[1:]), dtype=g.dtype,
                               device=g.device)
            dist.reduce_scatter_tensor(part, full)
            out[k] = part.movedim(0, d)
        return out

    def gather_(self) -> None:
        """All-gather every sharded parameter's shards into the whole
        parameter."""
        with torch.no_grad():
            for k in self.sharded:
                p = self.params[k]
                p.copy_(self.gather(k, self.shard(k, p)))

    def gather(self, name: str, shard):
        """The whole tensor of parameter ``name`` from every rank's ``shard``."""
        d = self.dims[name]
        part = shard.movedim(d, 0).contiguous()
        full = torch.empty((part.shape[0] * self.world, *part.shape[1:]), dtype=part.dtype,
                           device=part.device)
        dist.all_gather_into_tensor(full, part)
        return full.movedim(0, d)

    def sq_norm(self, names, norms) -> torch.Tensor:
        """The squared global norm of a gradient tree from the per-tensor
        norms of the tensors the optimizer holds: the shards' squares summed
        over the ranks, the replicated tensors' counted once."""
        sharded = [n * n for k, n in zip(names, norms) if self.dims.get(k) is not None]
        whole = [n * n for k, n in zip(names, norms) if self.dims.get(k) is None]
        total = torch.stack(whole).sum() if whole else torch.zeros((), device=norms[0].device)
        if sharded:
            total = total + global_sum(torch.stack(sharded).sum())
        return total

    def _map(self, tree, fn):
        if isinstance(tree, dict):
            return {k: (fn(k, v) if isinstance(v, torch.Tensor) and k in self.dims
                        else self._map(v, fn)) for k, v in tree.items()}
        return tree

    def full_state(self, opt_state):
        """The optimizer state with every sharded parameter's tensors
        gathered whole (a collective: every rank calls it)."""
        return self._map(opt_state, lambda k, v: v if self.dims[k] is None else self.gather(k, v))

    def shard_state(self, opt_state):
        """An unsharded optimizer state cut to this rank's shards."""
        return self._map(opt_state, lambda k, v: self.shard(k, v).clone())
