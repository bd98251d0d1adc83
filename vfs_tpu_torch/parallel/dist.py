"""Process groups for training over several processes (counterpart of
``vfs_tpu/parallel/mesh.py`` and of ``comm.py``'s ``reduce_log_vars``; the
other helpers of ``comm.py`` are in ``parallel/comm.py``).

The JAX package's contract (``shard_local_batch``, mesh.py:79-104) holds:
each process loads shard ``rank`` of ``world`` of every epoch's index
stream (``datasets.build_dataloader``), computes the mean loss of its own
shard, and ``DistributedDataParallel`` averages the gradients, which with
equal shards is the gradient of the global batch's mean loss. BatchNorm
statistics are those of the global batch (``models.common.norm``), with
the gradient through them. Breaking that contract (identical data on
every process, or per-process statistics) trains another model.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch
import torch.distributed as dist
import torch.nn as nn

from ..models.common.norm import set_sync_group


def init_dist(launcher: Optional[str], device_type: str = 'cuda') -> None:
    """Join the process group that ``launcher`` describes: ``'pytorch'``
    reads torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR``, ``MASTER_PORT``), with NCCL on CUDA (and the CUDA
    device ``LOCAL_RANK``) and gloo on the CPU. ``None`` / ``'none'``: one
    process, nothing to join."""
    if launcher in (None, 'none'):
        return
    if launcher != 'pytorch':
        raise ValueError(f"launcher {launcher!r}: 'none' or 'pytorch'")
    if device_type == 'cuda':
        torch.cuda.set_device(int(os.environ.get('LOCAL_RANK', 0)))
    dist.init_process_group('nccl' if device_type == 'cuda' else 'gloo',
                            init_method='env://')


def get_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def get_world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def wrap_distributed(model: nn.Module, device: torch.device) -> nn.Module:
    """In a process group of several processes: global BatchNorm
    statistics and ``DistributedDataParallel`` around ``model`` (whose
    parameters the optimizer keeps); alone: ``model`` itself."""
    if get_world_size() == 1:
        return model
    set_sync_group(model, dist.group.WORLD)
    return nn.parallel.DistributedDataParallel(
        model, device_ids=[device] if device.type == 'cuda' else None,
        # every process computes the same global statistics
        broadcast_buffers=False)


def reduce_log_vars(log_vars: Dict[str, torch.Tensor]
                    ) -> Dict[str, float]:
    """Scalar log vars averaged over the processes (reference
    trackers/base.py:104-108), as floats."""
    names = list(log_vars)
    values = torch.stack([log_vars[k].detach().float() for k in names])
    if get_world_size() > 1:
        dist.all_reduce(values)
        values = values / get_world_size()
    return dict(zip(names, values.tolist()))
