"""Communication helpers across the processes of a group (counterpart of
``vfs_tpu/parallel/comm.py``).

The reference's explicit ``torch.distributed`` helpers, which the JAX
package writes against a mesh axis:

- ``concat_all_gather``  <- reference mmaction/models/common/utils.py:68-81
- ``batch_shuffle`` /
  ``batch_unshuffle``    <- reference mmaction/models/common/utils.py:118-163
  (MoCo-style shuffled BatchNorm)
- ``allreduce_grads``    <- reference mmaction/core/dist_utils.py:30-49
- ``concat_all_gather_sharded``: the JAX package's gather of a
  batch-sharded array outside ``shard_map``; here the local shards of a
  process group.

``reduce_log_vars`` lives in ``dist.py``. The default training path needs
none of these (``DistributedDataParallel`` averages the gradients, and the
BatchNorm of ``models.common.norm`` takes global statistics); they serve
research heads that gather a negative bank or shuffle a batch. Each takes
``group`` (default: the world) and works on a process's local shard of
equal size on every process; outside a process group each is the
identity, as the JAX functions are on one device. Inside one, a group of
one process included, each runs its collectives.
"""

from __future__ import annotations

from typing import Optional, Tuple, TypeVar

import torch
import torch.distributed as dist

__all__ = ['concat_all_gather', 'batch_shuffle', 'batch_unshuffle',
           'allreduce_grads', 'concat_all_gather_sharded']

Grads = TypeVar('Grads')


def _world_rank(group) -> Tuple[int, int]:
    if not dist.is_initialized():
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


def _gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    if not dist.is_initialized():
        return x
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, 0)


def concat_all_gather(x: torch.Tensor,
                      group: Optional[dist.ProcessGroup] = None
                      ) -> torch.Tensor:
    """Every process's ``x`` (its batch shard) concatenated along dim 0,
    on every process, in rank order. Carries no gradient, like
    ``torch.distributed.all_gather`` in the reference and
    ``stop_gradient`` in the JAX package: the result is detached."""
    return _gather_rows(x.detach(), group)


def batch_shuffle(x: torch.Tensor, generator: torch.Generator,
                  group: Optional[dist.ProcessGroup] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shuffle the global batch across the processes (shuffled BN).

    ``generator`` must be seeded alike on every process: each draws the
    same permutation of the global batch from it (the JAX package's
    replicated key), so nothing is broadcast. Returns ``(x_local,
    idx_unshuffle)``: this process's rows of the shuffled global batch and
    the inverse permutation for ``batch_unshuffle``."""
    world, rank = _world_rank(group)
    n_local = x.shape[0]
    x_all = concat_all_gather(x, group)
    perm = torch.randperm(n_local * world, generator=generator,
                          device=generator.device).to(x.device)
    idx_unshuffle = torch.argsort(perm)
    return x_all[perm[rank * n_local:(rank + 1) * n_local]], idx_unshuffle


def batch_unshuffle(x: torch.Tensor, idx_unshuffle: torch.Tensor,
                    group: Optional[dist.ProcessGroup] = None
                    ) -> torch.Tensor:
    """Undo ``batch_shuffle``: this process's rows of the global batch in
    its original order."""
    world, rank = _world_rank(group)
    n_local = x.shape[0]
    x_all = concat_all_gather(x, group)
    return x_all[idx_unshuffle[rank * n_local:(rank + 1) * n_local]]


def allreduce_grads(grads: Grads,
                    group: Optional[dist.ProcessGroup] = None) -> Grads:
    """Average gradients across the processes, in place: ``grads`` is a
    tensor, a sequence of tensors or a dict of them, returned. The tensors
    of each dtype go through one all-reduce of their flattened
    concatenation (the reference's coalesced bucket)."""
    if not dist.is_initialized():
        return grads
    world = dist.get_world_size(group)
    leaves = (list(grads.values()) if isinstance(grads, dict)
              else [grads] if torch.is_tensor(grads) else list(grads))
    # dtypes in the order of their first tensor: the same on every process
    for dtype in dict.fromkeys(g.dtype for g in leaves):
        same = [g for g in leaves if g.dtype == dtype]
        flat = torch.cat([g.reshape(-1) for g in same])
        dist.all_reduce(flat, group=group)
        flat /= world
        for g, part in zip(same, flat.split([g.numel() for g in same])):
            g.copy_(part.view_as(g))
    return grads


class _GatherShards(torch.autograd.Function):
    """All-gather with the JAX package's identity gradient: the backward
    averages the full batch's gradient over the processes (each computed
    the same global function) and returns each process its shard's
    rows."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.n_local = x.shape[0]
        return _gather_rows(x, group)

    @staticmethod
    def backward(ctx, grad):
        world, rank = _world_rank(ctx.group)
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        grad /= world
        return grad[rank * ctx.n_local:(rank + 1) * ctx.n_local], None


def concat_all_gather_sharded(x: torch.Tensor,
                              group: Optional[dist.ProcessGroup] = None
                              ) -> torch.Tensor:
    """The global batch from every process's local shard ``x`` of a DDP
    process group, on every process: the JAX package's replication of a
    batch-sharded array (an identity, ``jax.jit`` with a replicated output
    sharding), gradient included (``_GatherShards``)."""
    if not dist.is_initialized():
        return x
    return _GatherShards.apply(x, group)
