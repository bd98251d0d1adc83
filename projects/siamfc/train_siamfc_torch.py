#!/usr/bin/env python
"""SiamFC train + OTB eval CLI of the PyTorch port (counterpart of
``train_siamfc.py``; reference: projects/siamfc-pytorch/
train_siamfc.py:46-177).

Usage:
    python projects/siamfc/train_siamfc_torch.py CONFIG \
        [--pretrained BACKBONE.pth] [--checkpoint EPOCH_N] \
        [--got10k-root D] [--otb-root D] [--work-dir W] \
        [--options k=v ...] [--local-devices N|all] [--track-batch K] \
        [--device cpu|cuda:N]

Runs on the current CUDA device unless ``--device`` names another (or the
CPU). The VFS config gives the backbone depth; depth >= 50 takes
``out_channels=2048`` and ``out_scale=1e-5``. With ``--pretrained`` and
``--got10k-root`` the linear probe trains first (checkpoints under
``W/checkpoints``); then OTB OPE runs when ``--otb-root`` exists, writing
``W/results/*.txt`` and ``W/reports/performance.json``, and the last line
printed is ``precision: P success: S speed: FPS``.
"""

import argparse
import os
import sys
from typing import Optional, Sequence

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from vfs_tpu_torch.tools.test import (  # noqa: E402
    local_devices, local_devices_arg)


def parse_args(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description='Train/eval SiamFC')
    parser.add_argument('config', help='VFS config (for backbone cfg)')
    parser.add_argument('--pretrained', default=None,
                        help='backbone checkpoint (.pth torch layout)')
    parser.add_argument('--checkpoint', default=None,
                        help='a train_over checkpoint (epoch_N) to restore')
    parser.add_argument('--got10k-root', default=None,
                        help='GOT-10k-style train sequences for probing')
    parser.add_argument('--otb-root', default='data/otb',
                        help='OTB dataset root')
    parser.add_argument('--work-dir', default='./work_dirs/siamfc')
    parser.add_argument('--options', nargs='+', default=None)
    parser.add_argument('--local-devices', default='1',
                        type=local_devices_arg,
                        help="track OTB sequences over N local devices "
                             "from --device on ('all': every CUDA device)")
    parser.add_argument('--track-batch', type=int, default=1,
                        help='track K sequences per device call')
    parser.add_argument('--device', default=None,
                        help='cpu or cuda:N (default: the current CUDA '
                             'device)')
    return parser.parse_args(argv)


def build_cfg(args):
    """default_cfg with the VFS config's depth and ``--options``."""
    from siamfc_tpu_torch import default_cfg

    from vfs_tpu_torch.utils import Config, parse_options
    cfg = dict(default_cfg)
    vfs_cfg = Config.fromfile(args.config)
    # merge the VFS config's backbone depth/channels (reference :49-50)
    backbone = dict(cfg['model']['backbone'])
    backbone['depth'] = vfs_cfg.model.backbone.depth
    cfg['model'] = {'backbone': backbone}
    if backbone['depth'] >= 50:
        cfg['out_channels'] = 2048
        cfg['out_scale'] = 1e-5
    if args.options:
        for k, v in parse_options(args.options).items():
            cfg[k] = v
    return cfg


def build_tracker(args):
    """The tracker on ``--device`` with its weights: seeded, then
    ``--pretrained``'s backbone, ``--checkpoint``'s state, and the linear
    probe when it applies."""
    from siamfc_tpu_torch import SequenceDataset, TrackerSiamFC

    from vfs_tpu_torch.checkpoint import restore_checkpoint
    from vfs_tpu_torch.utils import get_root_logger

    logger = get_root_logger()
    cfg = build_cfg(args)
    tracker = TrackerSiamFC(cfg, logger, device=args.device)
    tracker.init_weights(pretrained=args.pretrained)
    if args.checkpoint:
        tracker.net.load_state_dict(
            restore_checkpoint(args.checkpoint)['model'])

    if args.pretrained and args.got10k_root and (
            cfg['model']['backbone'].get('frozen_stages', -1) >= 0
            or cfg['extra_conv']):
        seqs = SequenceDataset(args.got10k_root)
        logger.info(f'linear probing on {len(seqs)} sequences')
        tracker.train_over(seqs, work_dir=args.work_dir)
    return tracker


def main(argv: Optional[Sequence[str]] = None):
    """Returns the OTB report (None when ``--otb-root`` does not exist)."""
    args = parse_args(argv)
    from siamfc_tpu_torch import ExperimentOTB

    from vfs_tpu_torch.utils import get_root_logger

    logger = get_root_logger()
    tracker = build_tracker(args)
    if not os.path.isdir(args.otb_root):
        logger.info(f'OTB root {args.otb_root} not found; skipping eval')
        return None
    exp = ExperimentOTB(
        args.otb_root, version=2015,
        result_dir=os.path.join(args.work_dir, 'results'),
        report_dir=os.path.join(args.work_dir, 'reports'))
    logger.info(f'running OTB OPE on {len(exp.seq_names)} sequences')
    devs = local_devices(args.local_devices, tracker.device)
    boxes = exp.run(tracker, devices=devs if len(devs) > 1 else None,
                    batch_size=args.track_batch)
    report = exp.report(boxes)
    logger.info(
        f"Results copypaste  {report['precision_score']*100:.1f}"
        f",{report['success_score']*100:.1f}")
    print(f"precision: {report['precision_score']:.4f} "
          f"success: {report['success_score']:.4f} "
          f"speed: {report['speed_fps']}")
    return report


if __name__ == '__main__':
    main()
