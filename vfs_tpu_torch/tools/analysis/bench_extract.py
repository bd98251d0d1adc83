"""Feature-extraction bench (counterpart of
``tools/analysis/bench_extract.py``): ms/frame of
``VanillaTracker._extract_feats`` on frames already on the device (uint8,
normalised on the device, as the eval path feeds them), over
``--steps`` (``batch_step``) and the backbone's dtype (fp32, bf16).

FLOPs come from ``torch.utils.flop_counter.FlopCounterMode`` over one
backbone call: 2 per multiply-add of the convolutions and matrix
products (it counts no elementwise work). MFU is the FLOPs per second
over the card's published peak for the dtype (fp32 on the CUDA cores,
bf16 on the dense tensor cores), beside the card's name and power limit;
on the CPU there is no device peak and MFU is not computed.

Usage:
    python -m vfs_tpu_torch.tools.analysis.bench_extract [--frames 80]
        [--hw 480 854] [--depth 18] [--steps 5 10 20 40] [--repeats 3]
        [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from ...device import resolve_device
from ...models import build_model
from .common import add_device_arg, device_label, peak_flops, time_ms

MEAN = (123.675, 116.28, 103.53)
STD = (58.395, 57.12, 57.375)


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description='extraction stage bench')
    p.add_argument('--frames', type=int, default=80)
    p.add_argument('--hw', type=int, nargs=2, default=(480, 854))
    p.add_argument('--depth', type=int, default=18)
    p.add_argument('--steps', type=int, nargs='*', default=(5, 10, 20, 40))
    p.add_argument('--repeats', type=int, default=3)
    add_device_arg(p)
    return p.parse_args(argv)


def frame_flops(model, imgs: torch.Tensor, mean, std) -> float:
    """FLOPs of the backbone on one normalised frame (FlopCounterMode:
    convolutions and matrix products, 2 per multiply-add)."""
    from torch.utils.flop_counter import FlopCounterMode
    x = (imgs[:1].to(torch.float32) - mean) / std
    backbone = model._prepare(model.backbone, imgs.device)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        backbone(x)
    return float(counter.get_total_flops())


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    label = device_label(device)
    t, (h, w) = args.frames, args.hw
    rng = np.random.RandomState(0)
    imgs = torch.from_numpy(rng.randint(0, 255, (t, h, w, 3), np.uint8)
                            ).to(device)
    mean = torch.tensor(MEAN, device=device)
    std = torch.tensor(STD, device=device)
    print(f'depth={args.depth} {t}x{h}x{w} uint8 input on {label}')
    rows = []
    for dtype in ('float32', 'bfloat16'):
        model = build_model(
            dict(type='VanillaTracker',
                 backbone=dict(type='ResNet', depth=args.depth,
                               out_indices=(3,), dtype=dtype)),
            test_cfg=dict(precede_frames=20, topk=10, temperature=0.07,
                          strides=(1, 2, 1, 1), out_indices=(2,),
                          neighbor_range=24))
        model.init_weights(torch.Generator().manual_seed(0))
        model.to(device)
        flops = frame_flops(model, imgs, mean, std)
        peak = peak_flops(device, dtype)
        for bs in args.steps:
            if t % bs:
                continue
            ms = time_ms(lambda: model._extract_feats(imgs, bs, mean, std),
                         device, repeats=args.repeats) / t
            mfu = flops / (ms / 1e3) / peak if peak else None
            rows.append(dict(dtype=dtype, batch_step=bs, ms_per_frame=ms,
                             gflop_per_frame=flops / 1e9, mfu=mfu))
            mfu_s = f'MFU={100 * mfu:5.1f}%' if mfu is not None \
                else 'MFU not measured (no device peak on the CPU)'
            print(f'{dtype:9s} batch_step={bs:3d} {ms:8.3f} ms/frame  '
                  f'{flops / 1e9:7.1f} GFLOP/frame  {mfu_s}', flush=True)
        del model
    return dict(device=label, frames=t, hw=[h, w], depth=args.depth,
                rows=rows)


if __name__ == '__main__':
    main()
