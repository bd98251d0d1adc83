"""Propagation A/B bench (counterpart of ``tools/analysis/bench_kernel.py``):
ms/frame of each backend and kernel variant on the DAVIS-480p stride-8
shapes, and the argmax agreement of each against the exact fp32 scan
(``pallas_fp32``).

The variants carry the JAX tool's names and configurations and its
seeded inputs (numpy ``RandomState(0)`` features, the same first-frame
labels). A variant whose keys differ from another's only in TPU layout
knobs (``pallas_tile``, ``pallas_fetch``, ``pallas_store``,
``pallas_matmul``, ``pallas_group_frames``, ``video_sweep_rows``,
``video_pass_mode``, ``video_qpair``, ``video_compact``; and ``tiled``,
which is the v2 engine's path in the port) launches the same kernel as
that variant: it runs once, untimed, its logits must equal that
variant's bit for bit, and it is printed as ``same_as`` it. Each other
variant is timed with CUDA events around the whole ``propagate_video``
(median of ``--repeats`` after a warm-up call), ms/frame over the T - 1
propagated frames. A variant that fails is printed as failed and the
process exits 1.

Usage:
    python -m vfs_tpu_torch.tools.analysis.bench_kernel [--frames 80]
        [--hw 60 108] [--radius 12] [--channels 256] [--classes 8]
        [--topk 10] [--precede 20] [--repeats 3] [--tiles 8 8 8 16 ...]
        [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ...device import resolve_device
from ...ops.propagation import PropagationConfig, propagate_video
from .common import add_device_arg, device_label, time_ms


def parse_args(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description='Kernel A/B bench')
    parser.add_argument('--frames', type=int, default=80)
    parser.add_argument('--hw', type=int, nargs=2, default=(60, 108),
                        help='feature grid (480p stride-8 r18: 60x107->108)')
    parser.add_argument('--radius', type=int, default=12,
                        help='circle radius in cells (= neighbor_range/2)')
    parser.add_argument('--classes', type=int, default=8)
    parser.add_argument('--channels', type=int, default=256)
    parser.add_argument('--repeats', type=int, default=3)
    parser.add_argument('--topk', type=int, default=10)
    parser.add_argument('--precede', type=int, default=20)
    parser.add_argument('--tiles', type=int, nargs='*', default=None,
                        help='flat list of tile pairs of the pallas fp32 '
                             'variant (a TPU layout knob: aliases)')
    add_device_arg(parser)
    return parser.parse_args(argv)


def variants(args) -> Dict[str, PropagationConfig]:
    """The JAX tool's variants, by name."""
    base = dict(precede_frames=args.precede, topk=args.topk,
                temperature=0.07, with_first=True, with_first_neighbor=True,
                with_norm=True, neighbor_range=2 * args.radius)
    tile = (8, 16) if args.radius >= 16 else (8, 8)

    def cfg(**kw):
        return PropagationConfig(**base, **kw)

    if args.tiles:
        pairs = list(zip(args.tiles[::2], args.tiles[1::2]))
        out = {'pallas_fp32': cfg(backend='pallas', pallas_tile=tile)}
        out.update({f'pallas_fp32_{th}x{tw}': cfg(backend='pallas',
                                                  pallas_tile=(th, tw))
                    for th, tw in pairs})
        return out
    bf = dict(pallas_precision='bfloat16')
    v1 = dict(backend='pallas_video', pallas_tile=tile, video_engine='v1')
    v2 = dict(backend='pallas_video', pallas_tile=(8, 8), video_engine='v2')
    return {
        'pallas_fp32': cfg(backend='pallas', pallas_tile=tile),
        'tiled': cfg(backend='tiled'),
        'pallas_bf16': cfg(backend='pallas', pallas_tile=tile,
                           pallas_scores='bfloat16'),
        'pallas_wholefetch': cfg(backend='pallas', pallas_tile=tile,
                                 pallas_fetch='whole'),
        'pallas_bf16mm': cfg(backend='pallas', pallas_tile=tile, **bf),
        'pallas_batched': cfg(backend='pallas', pallas_tile=tile,
                              pallas_matmul='batched'),
        'pallas_bf16mm_batched': cfg(backend='pallas', pallas_tile=tile,
                                     pallas_matmul='batched', **bf),
        'pallas_packed': cfg(backend='pallas', pallas_tile=tile,
                             pallas_extract='packed'),
        'pallas_bf16mm_packed': cfg(backend='pallas', pallas_tile=tile,
                                    pallas_extract='packed', **bf),
        'video_fp32': cfg(**v1),
        'video_bf16mm': cfg(**v1, **bf),
        'video_bf16mm_16x8': cfg(**dict(v1, pallas_tile=(16, 8)), **bf),
        'video_bf16mm_perframe': cfg(**v1, video_extract='perframe', **bf),
        'video_bf16mm_pf_noexit': cfg(**v1, video_extract='perframe',
                                      video_early_exit=False, **bf),
        'video_bf16mm_rows2': cfg(**v1, video_sweep_rows=2, **bf),
        'video_bf16mm_rows4': cfg(**v1, video_sweep_rows=4, **bf),
        'video_bf16mm_argmax': cfg(**v1, video_pass_mode='argmax', **bf),
        'video2_bf16mm_auto': cfg(**v2, **bf),
        'video2_bf16mm_nocompact': cfg(**v2, video_compact=False, **bf),
        'video2_bf16mm_q1': cfg(**v2, video_qpair=1, **bf),
        'video2_fp32_auto': cfg(**v2),
    }


def kernel_key(cfg: PropagationConfig) -> tuple:
    """What the port runs for ``cfg``: two configurations with one key
    launch the same kernels on the same inputs (propagation.py's
    dispatch; the layout knobs have no effect)."""
    if cfg.backend == 'pallas':
        extract = 'packed' if cfg.pallas_extract == 'packed' else 'exact'
        return ('row3', cfg.pallas_precision, cfg.pallas_scores, extract)
    if cfg.backend == 'pallas_video' and cfg.video_engine != 'v2':
        return ('row2', cfg.pallas_precision, cfg.video_extract,
                cfg.video_early_exit)
    precision = cfg.pallas_precision if cfg.backend == 'pallas_video' \
        else 'float32'  # the cast applies on the two Pallas paths only
    return ('row1', precision)


def inputs(args, device):
    t, (h, w), c, k = args.frames, args.hw, args.channels, args.classes
    rng = np.random.RandomState(0)
    feats = torch.from_numpy(rng.randn(t, h, w, c).astype(np.float32))
    seg = torch.zeros((h, w, k), dtype=torch.float32)
    seg[..., 0] = 1.0
    seg[10:30, 20:60, 0] = 0.0
    seg[10:30, 20:60, 1] = 1.0
    return feats.to(device), seg.to(device)


def run(args) -> dict:
    device = resolve_device(args.device)
    feats, seg = inputs(args, device)
    t = args.frames
    results, outputs, failed, aliases, first = {}, {}, {}, {}, {}
    for name, cfg in variants(args).items():
        key = kernel_key(cfg)
        try:
            if key in first:  # the same kernel as an earlier variant
                out = propagate_video(feats, seg, None, cfg)
                if not torch.equal(out, outputs[first[key]]):
                    raise AssertionError(f'differs from {first[key]}, '
                                         'which runs the same kernel')
                aliases[name] = first[key]
                continue
            outputs[name] = propagate_video(feats, seg, None, cfg)
            ms = time_ms(lambda: propagate_video(feats, seg, None, cfg),
                         device, repeats=args.repeats, warmup=0)
        except Exception as e:  # reported below, and the exit code is 1
            failed[name] = f'{type(e).__name__}: {str(e).splitlines()[0]}'
            continue
        first[key] = name
        results[name] = ms / (t - 1)
    ref = outputs['pallas_fp32'].argmax(-1) if 'pallas_fp32' in outputs \
        else None
    agree = {name: (float((out.argmax(-1) == ref).float().mean())
                    if ref is not None else None)
             for name, out in outputs.items()}
    return dict(device=device_label(device),
                shape=dict(frames=t, hw=list(args.hw),
                           channels=args.channels, classes=args.classes,
                           radius=args.radius, topk=args.topk,
                           precede=args.precede),
                ms_per_frame=results, agreement=agree, same_as=aliases,
                failed=failed)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    res = run(args)
    s = res['shape']
    print(f"shapes: T={s['frames']} {s['hw'][0]}x{s['hw'][1]}x"
          f"{s['channels']} K={s['classes']} radius={s['radius']} "
          f"topk={s['topk']} P={s['precede']} on {res['device']}")
    for name, ms in res['ms_per_frame'].items():
        print(f'{name:24s} {ms:8.3f} ms/frame   argmax-agreement vs '
              f"pallas_fp32: {res['agreement'][name]:.5f}")
    for name, same in res['same_as'].items():
        print(f'{name:24s} same_as {same} (layout knobs only: the same '
              'kernel, equal logits)')
    for name, err in res['failed'].items():
        print(f'{name:24s} FAILED: {err}')
    return res


def cli(argv: Optional[Sequence[str]] = None) -> int:
    """The process's exit code: 1 if a variant failed."""
    return 1 if main(argv)['failed'] else 0


if __name__ == '__main__':
    sys.exit(cli())
