"""Pretraining throughput (counterpart of
``tools/analysis/bench_pretrain.py``): SimSiam steps of a config (the r18
config by default) on synthetic Kinetics-layout clips
(``fixtures.write_k400``: mp4v ``.mp4`` where cv2 can write it, else MJPG
``.avi``; the output names the container), measuring the three rates
that decide whether the device starves:

  1. loader-only samples/s (decode, augmentation and collation in the
     config's loader processes, no device), after the first batch;
  2. device-only steps/s (one batch already on the device, the train
     step of ``apis.train``; CUDA events on a card, the host clock on the
     CPU), after one warm-up step;
  3. end-to-end steps/s (the loader feeding the device), with the share
     of the wall spent waiting on the loader.

Not input-starved when (1) >= batch x (2); then (3) is close to (2).
``--bf16`` takes the config's mixed precision (a bf16 backbone, fp32
weights and BatchNorm statistics). ``--device-aug`` moves the
augmentation chain into the step (``ops.device_aug.DeviceAugChain``, as
``tools.train`` runs a config with ``device_aug``): the host pipeline is
cut at its first device-supported transform (``split_device_aug_pipeline``)
and ships uint8 frames resized to ``--staging H W``; a config that is
already split (the ``_deviceaug`` config) keeps its pipeline and chain,
and needs the flag. ``--profile DIR`` writes a ``torch.profiler`` trace of
the end-to-end window to ``DIR/trace.json``.

Usage:
    python -m vfs_tpu_torch.tools.analysis.bench_pretrain [CONFIG]
        [--steps 20] [--batch-size 32] [--workers 16] [--num-videos N]
        [--video-frames 100] [--video-hw 256 340] [--data-dir D] [--bf16]
        [--device-aug] [--staging 256 320] [--profile DIR] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import time
from typing import Optional, Sequence

import torch

from ...apis.train import (_pipeline_norm_cfg, _start_profiler,
                           apply_mixed_precision, make_train_step)
from ...core.optimizer import build_optimizer
from ...datasets import build_dataloader, build_dataset
from ...device import resolve_device
from ...models import build_model
from ...ops.device_aug import build_device_aug
from ...utils import Config
from .common import add_device_arg, device_label, sync, time_ms
from .fixtures import write_k400

DEFAULT_CONFIG = osp.join(
    osp.dirname(osp.dirname(osp.dirname(osp.dirname(osp.abspath(
        __file__))))), 'configs', 'r18_nc_sgd_cos_100e_r2_1xNx8_k400.py')


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description='Pretrain throughput')
    p.add_argument('config', nargs='?', default=DEFAULT_CONFIG)
    p.add_argument('--steps', type=int, default=20)
    p.add_argument('--batch-size', type=int, default=None,
                   help='default: cfg.data.videos_per_gpu')
    p.add_argument('--workers', type=int, default=None,
                   help='default: cfg.data.workers_per_gpu')
    p.add_argument('--num-videos', type=int, default=None,
                   help='default: 2 x batch size')
    p.add_argument('--video-frames', type=int, default=100,
                   help='frames a synthetic clip (the JAX tool\'s 100)')
    p.add_argument('--video-hw', type=int, nargs=2, default=(256, 340),
                   metavar=('H', 'W'), help='size of a synthetic clip')
    p.add_argument('--data-dir', default=None,
                   help='reuse or write the clips here (default: '
                        'work_dirs/bench_pretrain_k400_<N>x<frames>)')
    p.add_argument('--profile', default=None, metavar='DIR',
                   help='torch.profiler trace of the end-to-end window')
    p.add_argument('--bf16', action='store_true',
                   help='bf16 mixed precision (bf16 backbone, fp32 '
                        'weights and BatchNorm statistics)')
    p.add_argument('--device-aug', action='store_true',
                   help='run the augmentation chain in the step on the '
                        'device (ops.device_aug): the host decodes and '
                        'resizes to --staging')
    p.add_argument('--staging', type=int, nargs=2, default=(256, 320),
                   metavar=('H', 'W'),
                   help='uint8 staging size shipped to the device with '
                        '--device-aug')
    add_device_arg(p)
    return p.parse_args(argv)


# transform types the device chain supports (ops/device_aug.py)
_DEVICE_AUG_TYPES = ('RandomResizedCrop', 'Resize', 'Flip', 'ColorJitter',
                     'RandomGrayScale', 'RandomGaussianBlur')
_TERMINAL = ('Normalize', 'FormatShape', 'Collect', 'ToTensor')


def split_device_aug_pipeline(pipeline, staging):
    """Split a host train pipeline at its first device-supported transform
    (the JAX tool's rule, tools/analysis/bench_pretrain.py:74-122): what
    comes before stays on the host, in order; from there on every
    transform must be device-supported or terminal (Normalize,
    FormatShape, Collect, ToTensor: dropped, the step normalises), else
    ``ValueError``, since moving it would reorder the augmentations. A
    keep-ratio ``Resize`` is host preparation. The host part ends with
    ``DeviceAug(scale=(W, H) of staging)`` and a ``Collect`` of ``imgs``,
    ``label`` and ``orig_hw``. A pipeline that already holds
    ``DeviceAug`` comes back as it is, with None for the device part.
    Returns (host_pipeline, device_transforms)."""
    def is_device_op(t):
        if t['type'] not in _DEVICE_AUG_TYPES:
            return False
        return not (t['type'] == 'Resize' and t.get('keep_ratio', True))

    if any(t['type'] == 'DeviceAug' for t in pipeline):
        return [dict(t) for t in pipeline], None
    host, device = [], []
    for t in pipeline:
        if is_device_op(t):
            device.append(dict(t))
        elif t['type'] in _TERMINAL:
            continue
        elif device:
            raise ValueError(
                f'--device-aug cannot move {t["type"]!r} onto the device '
                'and it comes after device-side transforms: reorder the '
                'pipeline or drop --device-aug')
        else:
            host.append(dict(t))
    host.append(dict(type='DeviceAug', scale=(staging[1], staging[0])))
    host.append(dict(type='Collect', keys=['imgs', 'label', 'orig_hw'],
                     meta_keys=()))
    return host, device


def next_batch(loader, it):
    batch = next(it, None)
    if batch is None:
        it = iter(loader)
        batch = next(it)
    return batch, it


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = Config.fromfile(args.config)
    batch = args.batch_size or cfg.data['videos_per_gpu']
    workers = cfg.data['workers_per_gpu'] if args.workers is None \
        else args.workers
    num_videos = args.num_videos or 2 * batch
    data_dir = args.data_dir or osp.join(
        'work_dirs', f'bench_pretrain_k400_{num_videos}x{args.video_frames}')
    ann = osp.join(data_dir, 'k400_train_list.txt')
    if not osp.isfile(ann):
        os.makedirs(data_dir, exist_ok=True)
        write_k400(data_dir, num_videos, args.video_frames,
                   tuple(args.video_hw))
    with open(ann) as f:
        container = osp.splitext(f.readline().split()[0])[1].lstrip('.')
    train_cfg = dict(cfg.data['train'])
    inner = dict(train_cfg.get('dataset', train_cfg))
    inner.update(ann_file=ann, data_prefix=data_dir)
    device_aug = None
    if args.device_aug:
        host_pipe, transforms = split_device_aug_pipeline(
            inner['pipeline'], tuple(args.staging))
        inner['pipeline'] = host_pipe
        da = dict(cfg.get('device_aug') or {})
        if transforms is None:  # the config is split already
            transforms = da['transforms']
        device_aug = build_device_aug(
            transforms, da.get('img_norm_cfg') or cfg.get('img_norm_cfg'),
            out_hw=tuple(da.get('out_hw', (224, 224))))
        sw, sh = next(t['scale'] for t in host_pipe
                      if t['type'] == 'DeviceAug')
        print(f'device-aug: {len(transforms)} transforms on {device}, '
              f'staging {(sh, sw)} uint8 -> {device_aug.out_hw}')
    elif cfg.get('device_aug') or any(t['type'] == 'DeviceAug'
                                      for t in inner['pipeline']):
        raise ValueError('the config runs its augmentations on the device '
                         '(device_aug): pass --device-aug')
    dataset = build_dataset(inner)
    loader = build_dataloader(dataset, videos_per_gpu=batch,
                              workers_per_gpu=workers, shuffle=True,
                              drop_last=True, seed=0)

    # 1) loader only
    it = iter(loader)
    first = next(it)  # absorbs the workers' start
    n_batches = max(2, min(len(loader) - 1, args.steps))
    t0 = time.perf_counter()
    got = 0
    for _ in range(n_batches):
        b, it = next_batch(loader, it)
        got += b['imgs'].shape[0]
    loader_sps = got / (time.perf_counter() - t0)

    # 2) device only: one batch on the device
    if args.bf16:
        cfg.bf16 = True
        apply_mixed_precision(cfg)
    model = build_model(cfg.model, train_cfg=cfg.get('train_cfg'))
    model.init_weights(torch.Generator().manual_seed(0))
    model.to(device).train()
    if device.type == 'cuda':
        model.backbone.to(memory_format=torch.channels_last)
    optimizer, _ = build_optimizer(model.parameters(), cfg.optimizer,
                                   cfg.get('lr_config'), 1000, 100)
    step = make_train_step(model, optimizer, _pipeline_norm_cfg(dataset)
                           or cfg.get('img_norm_cfg'), device_aug)
    imgs = torch.as_tensor(first['imgs']).to(device)
    orig_hw = first.get('orig_hw')
    step_ms = time_ms(lambda: step(imgs, orig_hw), device,
                      repeats=args.steps)
    device_sps = 1e3 / step_ms

    # 3) end to end
    profiler = _start_profiler(device) if args.profile else None
    it = iter(loader)
    sync(device)
    t0 = time.perf_counter()
    blocked = 0.0
    for _ in range(args.steps):
        tf = time.perf_counter()
        b, it = next_batch(loader, it)
        blocked += time.perf_counter() - tf
        log_vars = step(b['imgs'], b.get('orig_hw'))
    float(log_vars['loss'])
    sync(device)
    e2e_s = time.perf_counter() - t0
    trace = None
    if profiler is not None:
        profiler.stop()
        os.makedirs(args.profile, exist_ok=True)
        trace = osp.join(args.profile, 'trace.json')
        profiler.export_chrome_trace(trace)
    e2e_sps = args.steps / e2e_s

    clips, clip_len = first['imgs'].shape[1], first['imgs'].shape[2]
    frames = batch * clips * clip_len
    label = device_label(device)
    print(f'config: batch={batch} workers={workers} imgs/step={frames} '
          f"shape={tuple(first['imgs'].shape)} on {label}; clips: "
          f'{container} in {data_dir}')
    print(f'loader-only:  {loader_sps:.2f} samples/s '
          f'({loader_sps / batch:.3f} equivalent steps/s)')
    print(f'device-only:  {device_sps:.3f} steps/s ({step_ms:.1f} ms/step, '
          f'{device_sps * frames:.0f} frames/s)')
    print(f'end-to-end:   {e2e_sps:.3f} steps/s, loader-blocked '
          f'{100 * blocked / e2e_s:.1f}% of wall')
    starved = loader_sps < device_sps * batch
    print('input-starved:', 'yes: the loader is slower than the device'
          if starved else 'no (the loader outruns the device)')
    return dict(device=label, batch=batch, workers=workers,
                loader_samples_per_s=loader_sps, device_steps_per_s=device_sps,
                device_ms_per_step=step_ms, e2e_steps_per_s=e2e_sps,
                loader_blocked_share=blocked / e2e_s, starved=starved,
                bf16=args.bf16, device_aug=args.device_aug,
                container=container, trace=trace)


if __name__ == '__main__':
    main()
