"""A ``torch.profiler`` trace of the propagation hot path (counterpart of
``tools/analysis/profile_kernel.py``): ``--repeats`` calls of
``propagate_video`` at the DAVIS-480p shapes of r18 or r50, in the JAX
tool's eval configuration (``backend='pallas_video'``, bf16 features,
P = 20, top-10), on resident seeded features.

It prints the wall time per frame and, in place of XLA's per-op table,
the per-kernel breakdown the profiler reports on the card: CUDA time,
its share and the calls of each kernel (CPU time of each op on the
CPU). The Chrome trace goes to ``--out/trace.json``. A profiler that
cannot start raises, as ``--profile`` does in ``tools.train``.

Usage:
    python -m vfs_tpu_torch.tools.analysis.profile_kernel [--out DIR]
        [--frames 80] [--depth 18|50] [--repeats 5] [--device cpu]
        [--hw 60 108]
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ...device import resolve_device
from ...models.trackers.vanilla_tracker import make_propagation_config
from ...ops.propagation import propagate_video
from .common import add_device_arg, device_label, sync

# (channels, neighbor_range) of each depth's eval features
DEPTHS = {18: (256, 24), 50: (1024, 36)}
TOP = 15  # kernels printed


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description='Propagation profiler trace')
    p.add_argument('--out', default='work_dirs/prop_trace')
    p.add_argument('--frames', type=int, default=80)
    p.add_argument('--depth', type=int, default=18, choices=(18, 50))
    p.add_argument('--repeats', type=int, default=5)
    p.add_argument('--hw', type=int, nargs=2, default=(60, 108),
                   help='feature grid (DAVIS 480p at stride 8)')
    add_device_arg(p)
    return p.parse_args(argv)


def breakdown(prof, device: torch.device, top: int):
    """[(name, ms, share, calls)] of the kernels by their device time on a
    card (of the ops by their host time on the CPU), largest first, and
    the total ms."""
    from torch.autograd import DeviceType
    if device.type == 'cuda':
        rows = [(e.key, e.self_device_time_total / 1e3, e.count)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
    else:
        rows = [(e.key, e.self_cpu_time_total / 1e3, e.count)
                for e in prof.key_averages()]
    rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
    total = sum(r[1] for r in rows)
    return [(n, ms, ms / total, c) for n, ms, c in rows[:top]], total


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    from torch.profiler import ProfilerActivity, profile, schedule
    device = resolve_device(args.device)
    (h, w), (c, nr) = args.hw, DEPTHS[args.depth]
    cfg, mask = make_propagation_config(
        dict(precede_frames=20, topk=10, temperature=0.07,
             pallas_precision='bfloat16', backend='pallas_video',
             neighbor_range=nr), h, w)
    rng = np.random.RandomState(0)
    feats = torch.from_numpy(
        rng.randn(args.frames, h, w, c).astype(np.float32)).to(device)
    seg = torch.zeros((h, w, 8), dtype=torch.float32)
    seg[..., 0] = 1.0
    seg[10:30, 20:60, 0] = 0.0
    seg[10:30, 20:60, 1] = 1.0
    seg = seg.to(device)
    propagate_video(feats, seg, mask, cfg)  # kernels built and warm
    sync(device)

    activities = [ProfilerActivity.CPU]
    if device.type == 'cuda':
        activities.append(ProfilerActivity.CUDA)
    # one warm-up step inside the profiler before the recorded ones: the
    # device tracer may miss the kernels launched as it starts
    with profile(activities=activities,
                 schedule=schedule(wait=0, warmup=1, active=args.repeats,
                                   repeat=1)) as prof:
        propagate_video(feats, seg, mask, cfg)
        sync(device)
        prof.step()
        t0 = time.perf_counter()
        for _ in range(args.repeats):
            propagate_video(feats, seg, mask, cfg)
            prof.step()
        sync(device)
        wall_ms = 1e3 * (time.perf_counter() - t0)
    os.makedirs(args.out, exist_ok=True)
    trace = os.path.join(args.out, 'trace.json')
    prof.export_chrome_trace(trace)
    rows, total = breakdown(prof, device, TOP)
    per_frame = wall_ms / args.repeats / args.frames
    print(f'{args.repeats} x {args.frames} frames: {wall_ms:.1f} ms wall = '
          f'{per_frame:.3f} ms/frame (r{args.depth} shapes, '
          f'{device_label(device)})')
    what = 'CUDA' if device.type == 'cuda' else 'host CPU'
    print(f'{what} time by kernel: {total:.2f} ms in all ({trace})')
    for name, ms, share, calls in rows:
        print(f'  {ms:10.3f} ms  {100 * share:5.1f}%  {calls:6d} calls  '
              f'{name[:90]}')
    if device.type == 'cuda' and total <= 0:
        raise RuntimeError('the profiler recorded no CUDA kernel time')
    return dict(device=device_label(device), depth=args.depth,
                frames=args.frames, repeats=args.repeats, wall_ms=wall_ms,
                ms_per_frame=per_frame, kernel_ms=total, trace=trace,
                kernels=[dict(name=n, ms=ms, share=s, calls=c)
                         for n, ms, s, c in rows])


if __name__ == '__main__':
    main()
