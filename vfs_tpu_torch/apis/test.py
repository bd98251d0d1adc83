"""Eval loop (counterpart of ``vfs_tpu/apis/test.py``; reference:
mmaction/apis/test.py:14-194).

- ``single_process_test``: one process iterates the dataset and runs
  ``model.forward_test`` per video, on one device or, with ``devices``,
  round-robin over several, one worker thread a device (the JAX package's
  multi-chip eval, the reference's ``MMDataParallel`` scatter);
- ``multi_process_test``: the processes of a ``torch.distributed`` group
  (NCCL on CUDA, gloo on the CPU) each evaluate the videos ``i`` with ``i
  % world == rank`` and gather every prediction, in dataset order, on
  every rank (the reference's ``collect_results_gpu``).
"""

from __future__ import annotations

import concurrent.futures
import threading
from typing import List, Sequence

import torch.distributed as dist

from ..device import DeviceLike, exact_fp32
from ..parallel import get_rank, get_world_size
from ..utils import get_root_logger, trace


def _frames(sample):
    imgs = sample['imgs']
    # (num_clips, T, H, W, C) -> (T, H, W, C); eval uses one clip
    if imgs.ndim == 5:
        assert imgs.shape[0] == 1
        imgs = imgs[0]
    return imgs


def single_process_test(model, dataset, devices: Sequence = None,
                        device: DeviceLike = None) -> List:
    """Evaluate every video on ``device`` (CUDA unless the caller says
    otherwise). A worker thread decodes the next video and copies it to
    the device (``model.preload``) while the current one computes
    (spans ``test.decode`` and ``test.preload`` on that thread,
    ``test.wait_input`` and ``test.video`` on the caller's, keyed by the
    video's index: ``utils.trace``). The port's ``forward_test`` returns
    after its predictions are on the host, so the JAX loop's deferred
    readback has nothing to overlap here.

    ``devices``: several devices (``'cuda:0'``, ``'cuda:1'``, ... or
    ``'cpu'`` more than once) to round-robin the videos over, one worker
    thread each, with one copy of the weights on each device
    (``model.distribute``, dropped when the run ends); results keep
    dataset order. One device in the list is ``device``."""
    if devices is not None and len(devices) > 1:
        return _multi_device_test(model, dataset, list(devices))
    if devices:
        device = devices[0]
    logger = get_root_logger()
    n = len(dataset)

    def fetch(i):
        with trace.span('test.decode', i):
            sample = dataset[i]
        with trace.span('test.preload', i):
            return sample, model.preload(_frames(sample), device=device)

    results = []
    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
        pending = pool.submit(fetch, 0) if n else None
        for i in range(n):
            with trace.span('test.wait_input', i):
                sample, imgs = pending.result()
            if i + 1 < n:
                pending = pool.submit(fetch, i + 1)
            with trace.span('test.video', i):
                results.extend(model.forward_test(
                    imgs, sample['ref_seg_map'], [sample['img_meta']],
                    device=device))
            logger.info(f'eval [{i + 1}/{n}] '
                        f'{sample["img_meta"].get("frame_dir", "")}')
    return results


def _multi_device_test(model, dataset, devices: List) -> List:
    """Round-robin the videos over ``devices``, one worker thread each:
    thread ``k`` decodes, copies and propagates videos ``k, k + len(devices),
    ...`` on ``devices[k]``. The exact fp32 mode is entered here, once for
    all threads: its flags are process-wide, so nested entries in the
    threads then leave them as they found them."""
    logger = get_root_logger()
    backbones = model.distribute(devices)
    n = len(dataset)
    results: List = [None] * n
    done = [0]
    lock = threading.Lock()

    def worker(k):
        dev = devices[k]
        for i in range(k, n, len(devices)):
            sample = dataset[i]
            imgs = model.preload(_frames(sample), device=dev)
            results[i] = model.forward_test(imgs, sample['ref_seg_map'],
                                            [sample['img_meta']], device=dev,
                                            backbone=backbones[k])
            with lock:
                done[0] += 1
                logger.info(f'eval [{done[0]}/{n}] ({dev}) '
                            f'{sample["img_meta"].get("frame_dir", "")}')

    with exact_fp32(), concurrent.futures.ThreadPoolExecutor(
            len(devices)) as pool:
        for f in [pool.submit(worker, k) for k in range(len(devices))]:
            f.result()  # a worker's exception surfaces here
    return [pred for preds in results for pred in preds]


class _Shard:
    """Videos ``rank, rank + world, ...`` of ``dataset``."""

    def __init__(self, dataset, rank: int, world: int):
        self.dataset, self.rank, self.world = dataset, rank, world

    def __len__(self):
        return len(range(self.rank, len(self.dataset), self.world))

    def __getitem__(self, i):
        return self.dataset[self.rank + i * self.world]


def multi_process_test(model, dataset, device: DeviceLike = None) -> List:
    """Evaluate this rank's shard of the videos (``i % world == rank``) on
    ``device`` with ``single_process_test``, then gather every rank's
    predictions (``all_gather_object``: pickled, through the group's
    backend) and return all of them in dataset order, on every rank.
    Without a process group it is ``single_process_test``."""
    if not dist.is_initialized():
        return single_process_test(model, dataset, device=device)
    rank, world = get_rank(), get_world_size()
    local = single_process_test(model, _Shard(dataset, rank, world),
                                device=device)
    gathered = [None] * world
    dist.all_gather_object(gathered, local)
    return [gathered[i % world][i // world] for i in range(len(dataset))]
