"""Host data-pipeline throughput (counterpart of
``tools/analysis/bench_processing.py``): ``--num-samples`` samples of a
config's dataset split through its decode and augmentation pipeline in
this process, on the host clock. It uses no device, so it has no
``--device``.

Usage:
    python -m vfs_tpu_torch.tools.analysis.bench_processing CONFIG
        [--num-samples 50] [--split train|val|test] [--options k=v ...]
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

from ...datasets import build_dataset
from ...utils import Config, parse_options


def parse_args(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description='data pipeline throughput')
    parser.add_argument('config')
    parser.add_argument('--num-samples', type=int, default=50)
    parser.add_argument('--split', default='train',
                        choices=['train', 'val', 'test'])
    parser.add_argument('--options', nargs='+', default=None)
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    cfg = Config.fromfile(args.config)
    if args.options:
        cfg.merge_from_dict(parse_options(args.options))
    dataset = build_dataset(cfg.data[args.split])
    n = min(args.num_samples, len(dataset))
    t0 = time.perf_counter()
    for i in range(n):
        dataset[i % len(dataset)]['imgs']
    dt = time.perf_counter() - t0
    print(f'{n} samples in {dt:.3f}s => {n / dt:.2f} samples/s '
          f'({dt / n * 1000:.1f} ms/sample, host)')
    return dict(samples=n, seconds=dt, samples_per_s=n / dt)


if __name__ == '__main__':
    main()
