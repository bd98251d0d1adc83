"""Training-log analysis (counterpart of ``tools/analysis/analyze_logs.py``)
over the JSONL that ``vfs_tpu_torch.tools.train`` writes
(``work_dir/train_log.jsonl``, ``JsonlLogger``): ``cal_train_time``
prints the mean, fastest and slowest iteration time of the train
records; ``plot_curve`` plots keys of the train records against the log
step into an image. ``plot_curve`` needs matplotlib and raises if it is
missing. No device.

Usage:
    python -m vfs_tpu_torch.tools.analysis.analyze_logs cal_train_time
        LOG [LOG ...]
    python -m vfs_tpu_torch.tools.analysis.analyze_logs plot_curve LOG
        [--keys loss] [--out curve.png]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np


def load_jsonl(path: str) -> List[Dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def train_records(path: str) -> List[Dict]:
    return [r for r in load_jsonl(path) if r.get('mode') == 'train']


def cal_train_time(logs: Sequence[str]) -> Dict[str, Optional[Dict]]:
    out = {}
    for path in logs:
        times = np.array([r['time'] for r in train_records(path)
                          if 'time' in r], np.float64)
        if not len(times):
            print(f'{path}: no train records')
            out[path] = None
            continue
        out[path] = dict(mean=float(times.mean()), fastest=float(times.min()),
                         slowest=float(times.max()), n=len(times))
        print(f'{path}: avg iter time {times.mean():.4f}s (fastest '
              f'{times.min():.4f}, slowest {times.max():.4f})')
    return out


def plot_curve(logs: Sequence[str], keys: Sequence[str], out: str) -> str:
    try:
        import matplotlib
    except ImportError as e:
        raise RuntimeError('plot_curve needs matplotlib, which is not '
                           'installed') from e
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    fig = plt.figure()
    for path in logs:
        records = train_records(path)
        for key in keys:
            plt.plot(range(len(records)), [r.get(key) for r in records],
                     label=f'{os.path.basename(path)}:{key}')
    plt.xlabel('log step')
    plt.legend()
    fig.savefig(out)
    plt.close(fig)
    print(f'saved {out}')
    return out


def main(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description='training-log analysis')
    sub = parser.add_subparsers(dest='task', required=True)
    p1 = sub.add_parser('cal_train_time')
    p1.add_argument('logs', nargs='+')
    p2 = sub.add_parser('plot_curve')
    p2.add_argument('logs', nargs='+')
    p2.add_argument('--keys', nargs='+', default=['loss'])
    p2.add_argument('--out', default='curve.png')
    args = parser.parse_args(argv)
    if args.task == 'cal_train_time':
        return cal_train_time(args.logs)
    return plot_curve(args.logs, args.keys, args.out)


if __name__ == '__main__':
    main()
