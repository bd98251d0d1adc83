"""SiamFC tracking throughput A/B bench (counterpart of
``tools/analysis/bench_track.py``) through the port,
``projects/siamfc/siamfc_tpu_torch``, on the synthetic OTB-layout fixture
(``siamfc_tpu_torch.fixtures.make_otb_fixture``), with the r18 tracker of
the JAX tool (``default_cfg``, seeded weights). Frames per second of each
mode over the tracked frames (frame 0 left out), after a three-frame
warm-up outside the clock, and each mode's largest box difference from
``host_seq``, the sequential host-crop path the reference drives.

Modes:
  host_seq    sequential loop, host cv2 crops and host response post
  dev_seq     sequential loop, device crops and on-device response post
  host_batch  track_batch(K): K sequences per device call, host crops
  dev_batch   track_batch(K) with device crops
  dev_batch2  dev_batch over 2 interleaved streams (ExperimentOTB.run's
              composition)

Every mode runs in the exact fp32 mode (TF32 off), as ``ExperimentOTB.run``
tracks.

Usage:
    python -m vfs_tpu_torch.tools.analysis.bench_track [--seqs 6]
        [--frames 60] [--hw 360 640] [--batch 3] [--modes host_seq ...]
        [--root DIR] [--options exemplar_sz=120 ...] [--device cpu]
"""

from __future__ import annotations

import argparse
import ast
import concurrent.futures
import os
import os.path as osp
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ...device import exact_fp32, resolve_device
from .common import add_device_arg, device_label, sync

ROOT = osp.dirname(osp.dirname(osp.dirname(osp.dirname(osp.abspath(
    __file__)))))
MODES = ('host_seq', 'dev_seq', 'host_batch', 'dev_batch', 'dev_batch2')


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description='SiamFC tracking bench')
    p.add_argument('--seqs', type=int, default=6)
    p.add_argument('--frames', type=int, default=60)
    p.add_argument('--hw', type=int, nargs=2, default=(360, 640))
    p.add_argument('--batch', type=int, default=3,
                   help='sequences per device call in the batch modes')
    p.add_argument('--modes', nargs='*', default=None, choices=MODES)
    p.add_argument('--root', default='work_dirs/bench_track_fixture')
    p.add_argument('--options', nargs='*', default=(),
                   help='default_cfg overrides key=value (Python literals)')
    add_device_arg(p)
    return p.parse_args(argv)


def siamfc():
    """The port's SiamFC package (projects/siamfc/siamfc_tpu_torch)."""
    path = osp.join(ROOT, 'projects', 'siamfc')
    if path not in sys.path:
        sys.path.insert(0, path)
    import siamfc_tpu_torch
    return siamfc_tpu_torch


def build_tracker(cfg, device, device_crops):
    tracker = siamfc().TrackerSiamFC(dict(cfg, device_crops=device_crops),
                                     device=device)
    tracker.init_weights(generator=torch.Generator().manual_seed(0))
    return tracker


def run_mode(mode, tracker, pairs, batch, device):
    """(fps over the tracked frames, frame 0 left out; boxes a sequence)."""
    warm = [(pairs[0][0][:3], pairs[0][1])]
    if mode.endswith('seq'):
        tracker.track(*warm[0])
    else:
        tracker.track_batch(warm, batch_size=batch)
    sync(device)
    t0 = time.perf_counter()
    if mode.endswith('seq'):
        results = [tracker.track(f, b) for f, b in pairs]
    elif mode == 'dev_batch2':
        results = [None] * len(pairs)
        groups = [list(range(s, len(pairs), 2)) for s in range(2)]

        def worker(s):
            sub = tracker.track_batch([pairs[i] for i in groups[s]],
                                      batch_size=batch)
            for i, r in zip(groups[s], sub):
                results[i] = r

        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            for f in [pool.submit(worker, s) for s in range(2)]:
                f.result()
    else:
        results = tracker.track_batch(pairs, batch_size=batch)
    sync(device)
    wall = time.perf_counter() - t0
    frames = sum(len(f) - 1 for f, _ in pairs)
    return frames / wall, [np.asarray(r[0]) for r in results]


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    pkg = siamfc()
    from siamfc_tpu_torch.fixtures import make_otb_fixture
    from siamfc_tpu_torch.otb import _load_otb_seq
    if not osp.isdir(args.root):
        make_otb_fixture(args.root, args.seqs, args.frames, tuple(args.hw))
    seq_dirs = sorted(d for d in (osp.join(args.root, n)
                                  for n in os.listdir(args.root))
                      if osp.isdir(osp.join(d, 'img')))
    pairs = [(f, a[0]) for f, a in map(_load_otb_seq, seq_dirs)]
    cfg = dict(pkg.default_cfg)
    for opt in args.options:
        key, value = opt.split('=', 1)
        cfg[key] = ast.literal_eval(value)
    modes = args.modes or list(MODES)
    print(f'{len(pairs)} seqs x {args.frames} frames @ {tuple(args.hw)}, '
          f'batch={args.batch} on {device_label(device)}')
    out, ref = {}, None
    with exact_fp32():
        for mode in modes:
            tracker = build_tracker(cfg, device, mode.startswith('dev'))
            fps, boxes = run_mode(mode, tracker, pairs, args.batch, device)
            if mode == 'host_seq':
                ref = boxes
            diff = None if ref is None or mode == 'host_seq' else max(
                float(np.abs(b - r).max()) for b, r in zip(boxes, ref))
            out[mode] = dict(fps=fps, box_vs_host_seq_px=diff)
            diff_s = '' if diff is None else \
                f'  max|box - host_seq| = {diff:.4f} px'
            print(f'{mode:<11} {fps:8.2f} fps{diff_s}', flush=True)
            del tracker
    return dict(device=device_label(device), seqs=len(pairs),
                frames=args.frames, hw=list(args.hw), batch=args.batch,
                modes=out)


if __name__ == '__main__':
    main()
