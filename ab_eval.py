#!/usr/bin/env python3
"""Compare the eval throughput of checkouts of this repo on one card.

    python3 ab_eval.py DIR_A DIR_B [--path davis|pose|vip] [--repeats N]
                       [--option KEY=VALUE ...]

Writes the inputs of one of ``chip_smoke.py``'s eval paths once, then runs
``python -m vfs_tpu_torch.tools.test`` on them in each checkout's own
package, one process per run, in the order A, B, B, A:

- ``davis`` (the default): the r50 DAVIS eval, two synthetic 48x480x854
  videos, configs/r50_nc_sgd_cos_100e_r5_1xNx2_k400.py with
  ``test_cfg.backend=pallas`` (the scan tier, row 3);
- ``pose``: the r18 JHMDB eval, two synthetic 40-frame 240x320 videos,
  configs/r18_nc_sgd_cos_100e_r2_1xNx8_k400.py with ``--eval pck
  test_cfg.video_engine=v1 test_cfg.video_extract=perframe`` (row 2);
- ``vip``: the r50 VIP eval, two synthetic 48x480x854 videos, ``--eval
  mIoU test_cfg.video_engine=v1`` (row 2).

Each ``--option`` is appended to the path's ``--options`` (a later key
wins), e.g. ``--option test_cfg.video_engine=v2``. The checkpoints are
seeded random torchvision-layout weights. Each process first runs the
eval once (the kernel build and the first call), then times
``single_process_test`` ``N`` times (default 3). Prints one JSON line per
run with the checkout, its ``eval_fps`` per repeat and their median and
the peak device memory of the timed evals (``peak_memory_gb``), then the
card's name and power limit as ``nvidia-smi`` gives them. Needs one
card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.abspath(__file__))


def run_ab(a, b, argv, what):
    """Run ``python3 argv...`` with checkout A, B, B and A in turn as its
    working directory, each in its own process; yield each checkout and
    the JSON object on the last line of its output. Raises with the end
    of its errors if a run fails."""
    for checkout in (a, b, b, a):
        proc = subprocess.run([sys.executable, *argv], cwd=checkout,
                              capture_output=True, text=True)
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr[-4000:])
            raise RuntimeError(f'{what} failed in {checkout}')
        yield checkout, json.loads(proc.stdout.strip().splitlines()[-1])


def child(argv, repeats):
    """Run in a checkout: the eval once, then ``repeats`` timed evals;
    print the wall seconds of each and the peak device memory of the
    timed evals."""
    import chip_smoke  # the timers of this script's tree
    sys.path[0] = os.getcwd()  # the package of the checkout
    import torch
    import vfs_tpu_torch.apis as apis
    from vfs_tpu_torch.tools import test as tools_test
    walls = []
    with chip_smoke.patched(apis, 'single_process_test',
                            chip_smoke.wall_timer(walls)):
        for i in range(repeats + 1):
            if i == 1:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            tools_test.main(argv)
    print(json.dumps({'first_call_s': walls[0], 'walls': walls[1:],
                      'peak_memory_gb':
                      torch.cuda.max_memory_allocated() / 2**30}))


def write_inputs(path, root, options):
    """Write ``path``'s inputs under ``root``; return ``tools.test``'s
    arguments and the frames one eval runs."""
    import chip_smoke
    if path == 'davis':
        (img_root, ann_root, (list_all, _), shape,
         ckpt) = chip_smoke.write_eval_inputs(root)
        argv = chip_smoke.eval_argv(root, img_root, ann_root, list_all, ckpt,
                                    'pallas', os.path.join(root, 'out.npz'))
        return argv + list(options), 2 * shape[0]
    if path == 'pose':
        img_root, ann_root, (list_all, _), shape = chip_smoke.write_jhmdb(
            root)
        config, metric, dataset_type = chip_smoke.CONFIG, 'pck', 'JHMDBDataset'
        engine = ['test_cfg.video_engine=v1',
                  'test_cfg.video_extract=perframe']
    else:
        img_root, ann_root, (list_all, _), shape = chip_smoke.write_vip(root)
        config, metric, dataset_type = (chip_smoke.CONFIG_R50, 'mIoU',
                                        'VIPDataset')
        engine = ['test_cfg.video_engine=v1']
    ckpt = chip_smoke.write_backbone(config, os.path.join(root, 'w.pth'))
    dataset = dict(type=dataset_type, ann_file=list_all,
                   data_prefix=img_root, anno_prefix=ann_root,
                   data_root=root)
    argv = chip_smoke.slice3_argv(config, ckpt, metric, dataset,
                                  os.path.join(root, 'out.npz'),
                                  engine + list(options))
    return argv, 2 * shape[0]


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('checkouts', nargs=2)
    parser.add_argument('--path', choices=('davis', 'pose', 'vip'),
                        default='davis')
    parser.add_argument('--repeats', type=int, default=3)
    parser.add_argument('--option', action='append', default=[])
    parser.add_argument('--child', default=None, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.child is not None:
        return child(json.loads(args.child), args.repeats)

    import chip_smoke
    os.makedirs(os.path.join(ROOT, 'build'), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, 'build')) as root:
        argv, frames = write_inputs(args.path, root, args.option)
        a, b = (os.path.abspath(c) for c in args.checkouts)
        child_argv = [os.path.abspath(__file__), a, b, '--repeats',
                      str(args.repeats), '--child', json.dumps(argv)]
        for checkout, run in run_ab(a, b, child_argv, 'the eval'):
            fps = [frames / secs for secs in run['walls']]
            print(json.dumps({'checkout': os.path.relpath(checkout, ROOT),
                              'path': args.path, 'options': args.option,
                              'first_call_s': run['first_call_s'],
                              'eval_fps': fps,
                              'median_fps': statistics.median(fps),
                              'peak_memory_gb': run['peak_memory_gb']}),
                  flush=True)
    print(chip_smoke.card_line())


if __name__ == '__main__':
    sys.exit(main())
