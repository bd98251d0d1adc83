"""Train CLI (counterpart of ``tools/train.py``; reference:
tools/train.py:20-181).

Usage:
    python -m vfs_tpu_torch.tools.train CONFIG [--work-dir D] [--seed N] \\
        [--auto-resume] [--validate] [--options k=v ...] [--device cpu] \\
        [--launcher pytorch] [--profile N] [--disable-wandb]

Trains a tracker (self-supervised), a recognizer (on the labels of its
clips) or a temporal-action localizer (BMN, TEM, PEM or SSN, through
``apis.train_localizer``; ``--validate`` then logs a per-epoch val loss). Runs on CUDA unless ``--device`` says otherwise, and raises when
there is no GPU and no ``--device cpu``. ``--launcher pytorch`` joins the
process group that torchrun's environment describes (one process per
GPU, NCCL; gloo with ``--device cpu``).
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

from .test import local_devices_arg, local_devices


def parse_args(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description='Train a model')
    parser.add_argument('config', help='config file path')
    parser.add_argument('--work-dir', help='dir to save logs and ckpts')
    parser.add_argument('--resume-from',
                        help='not read; use --auto-resume')
    parser.add_argument('--auto-resume', action='store_true',
                        help='resume from latest checkpoint in work_dir')
    parser.add_argument('--seed', type=int, default=0, help='random seed')
    parser.add_argument('--validate', action='store_true',
                        help='run the propagation eval each epoch')
    parser.add_argument('--local-devices', default='1', type=local_devices_arg,
                        help="round-robin the --validate eval's videos over "
                             "N local devices ('all': every CUDA device)")
    parser.add_argument('--launcher', default='none',
                        choices=['none', 'pytorch'],
                        help="'pytorch': torchrun's environment")
    parser.add_argument('--options', nargs='+', default=None,
                        help='dotted-key config overrides k=v')
    parser.add_argument('--suffix', default=None,
                        help='appended to work_dir (and the wandb dir, '
                             'if configured)')
    parser.add_argument('--disable-wandb', action='store_true',
                        help='drop any WandbLoggerHook from log_config')
    parser.add_argument('--profile', type=int, default=0, metavar='N',
                        help='torch.profiler trace of train steps [2, 2+N) '
                             'into work_dir/profile')
    parser.add_argument('--compilation-cache', default=None,
                        help="the JAX package's XLA cache directory; "
                             'accepted and ignored (PyTorch runs eagerly)')
    parser.add_argument('--device', default=None,
                        help="device to run on; CUDA unless given "
                             "(e.g. 'cpu')")
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None):
    """Train; returns the final ``TrainState``."""
    args = parse_args(argv)
    import torch

    from ..apis.train import apply_mixed_precision, train_model
    from ..apis.train_localizer import (LOCALIZER_TYPES,
                                        train_localizer_model)
    from ..datasets import build_dataset
    from ..device import resolve_device
    from ..models import build_model
    from ..parallel import init_dist
    from ..utils import (Config, collect_env, get_root_logger,
                         parse_options, set_random_seed)

    if args.resume_from:
        raise ValueError('--resume-from is not read (nor by the JAX '
                         'package); use --auto-resume with the work dir')
    device_type = torch.device(args.device).type if args.device else 'cuda'
    init_dist(None if args.launcher == 'none' else args.launcher,
              device_type)
    device = resolve_device(args.device)

    cfg = Config.fromfile(args.config)
    if args.options:
        cfg.merge_from_dict(parse_options(args.options))
    if args.work_dir:
        cfg.work_dir = args.work_dir
    elif 'work_dir' not in cfg:
        cfg.work_dir = os.path.join(
            './work_dirs', os.path.splitext(os.path.basename(args.config))[0])
    if args.suffix is not None:
        cfg.work_dir = f'{cfg.work_dir}-{args.suffix}'
    hooks = (cfg.get('log_config') or {}).get('hooks', []) or []
    for i, h in enumerate(list(hooks)):
        if isinstance(h, dict) and h.get('type') == 'WandbLoggerHook':
            if args.disable_wandb:
                hooks.pop(i)
                break
            wdir = h.get('init_kwargs', {}).get('dir')
            if args.suffix is not None and wdir:
                h['init_kwargs']['dir'] = f'{wdir}-{args.suffix}'
    cfg.seed = args.seed
    cfg.profile_steps = args.profile
    cfg.auto_resume = args.auto_resume

    os.makedirs(cfg.work_dir, exist_ok=True)
    logger = get_root_logger(os.path.join(cfg.work_dir, 'train.log'))
    logger.info('Environment:\n' + '\n'.join(
        f'{k}: {v}' for k, v in collect_env().items()))
    logger.info(f'Config: {args.config}')
    cfg.dump(os.path.join(cfg.work_dir, os.path.basename(args.config)))
    set_random_seed(args.seed)

    apply_mixed_precision(cfg)
    model = build_model(cfg.model, train_cfg=cfg.get('train_cfg'),
                        test_cfg=cfg.get('test_cfg'))
    dataset = build_dataset(cfg.data.train)
    logger.info(f'Start training: {len(dataset)} samples, '
                f'{cfg.total_epochs} epochs')
    if cfg.model.get('type') in LOCALIZER_TYPES:
        if args.local_devices != '1':
            logger.info('--local-devices: a localizer validates by its loss '
                        'on the training device')
        return train_localizer_model(model, dataset, cfg,
                                     validate=args.validate, logger=logger,
                                     device=device)
    eval_devices = None
    if args.validate and args.local_devices != '1':
        eval_devices = local_devices(args.local_devices, device)
        if len(eval_devices) > 1:
            logger.info(f'validation over {len(eval_devices)} devices')
        else:
            eval_devices = None
    return train_model(model, dataset, cfg, validate=args.validate,
                       logger=logger, local_devices=eval_devices,
                       device=device)


if __name__ == '__main__':
    main()
