"""Eval loop (counterpart of ``vfs_tpu/apis/test.py``; reference:
mmaction/apis/test.py:14-194).

One process, one device: iterate the dataset and run
``model.forward_test`` per video. Eval over several GPUs (``devices``,
``multi_process_test``) comes with a later slice of the port.
"""

from __future__ import annotations

import concurrent.futures
from typing import List

from ..device import DeviceLike
from ..utils import get_root_logger


def single_process_test(model, dataset, devices=None,
                        device: DeviceLike = None) -> List:
    """Evaluate every video on ``device`` (CUDA unless the caller says
    otherwise). A worker thread decodes the next video and copies it to
    the device (``model.preload``) while the current one computes. The
    port's ``forward_test`` returns after its predictions are on the host,
    so the JAX loop's deferred readback has nothing to overlap here."""
    if devices is not None:
        raise NotImplementedError(
            'eval over several devices is ported in a later slice')
    logger = get_root_logger()
    n = len(dataset)

    def fetch(i):
        sample = dataset[i]
        imgs = sample['imgs']
        # (num_clips, T, H, W, C) -> (T, H, W, C); eval uses one clip
        if imgs.ndim == 5:
            assert imgs.shape[0] == 1
            imgs = imgs[0]
        return sample, model.preload(imgs, device=device)

    results = []
    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
        pending = pool.submit(fetch, 0) if n else None
        for i in range(n):
            sample, imgs = pending.result()
            if i + 1 < n:
                pending = pool.submit(fetch, i + 1)
            results.extend(model.forward_test(
                imgs, sample['ref_seg_map'], [sample['img_meta']],
                device=device))
            logger.info(f'eval [{i + 1}/{n}] '
                        f'{sample["img_meta"].get("frame_dir", "")}')
    return results


def multi_process_test(model, dataset) -> List:
    raise NotImplementedError(
        'eval over several processes is ported in a later slice')
