"""Inference frames per second over a test dataset (counterpart of
``tools/analysis/benchmark.py``; reference tools/analysis/benchmark.py:
29-91): the eval CLI's model and dataset (``vfs_tpu_torch.tools.test``),
``--num-warmup`` videos untimed, then each video's ``forward_test`` timed
on the host clock to its returned masks (on the host, so the device has
finished).

Usage:
    python -m vfs_tpu_torch.tools.analysis.benchmark CONFIG CHECKPOINT
        [--num-videos 10] [--num-warmup 1] [--options k=v ...]
        [--device cpu]
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np

from ...datasets import build_dataset
from ...device import resolve_device
from ...models import build_model
from ...utils import Config, parse_options
from .common import add_device_arg, device_label


def parse_args(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description='eval frames per second')
    parser.add_argument('config')
    parser.add_argument('checkpoint')
    parser.add_argument('--num-videos', type=int, default=10)
    parser.add_argument('--num-warmup', type=int, default=1)
    parser.add_argument('--options', nargs='+', default=None)
    add_device_arg(parser)
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = Config.fromfile(args.config)
    if args.options:
        cfg.merge_from_dict(parse_options(args.options))
    dataset = build_dataset(cfg.data.test, dict(test_mode=True))
    model_cfg = dict(type='VanillaTracker', backbone=dict(cfg.model.backbone))
    model_cfg['backbone']['pretrained'] = args.checkpoint
    model = build_model(model_cfg, test_cfg=cfg.test_cfg)
    model.init_weights()

    total_frames, total_time = 0, 0.0
    n = min(args.num_videos + args.num_warmup, len(dataset))
    for i in range(n):
        sample = dataset[i]
        imgs = sample['imgs']
        if imgs.ndim == 5:
            imgs = imgs[0]
        t0 = time.perf_counter()
        preds = model.forward_test(imgs, sample['ref_seg_map'],
                                   [sample['img_meta']], device=device)
        np.asarray(preds[0]).sum()
        dt = time.perf_counter() - t0
        if i >= args.num_warmup:
            total_frames += imgs.shape[0]
            total_time += dt
        print(f'video {i}: {imgs.shape[0]} frames in {dt:.3f}s '
              f'({imgs.shape[0] / dt:.2f} fps)')
    fps = total_frames / total_time if total_time > 0 else None
    if fps is not None:
        print(f'Overall: {fps:.2f} frames/sec on {device_label(device)}')
    return dict(device=device_label(device), videos=n - args.num_warmup,
                frames=total_frames, seconds=total_time, fps=fps)


if __name__ == '__main__':
    main()
