"""Eval CLI (counterpart of ``tools/test.py``; reference:
tools/test.py:17-166).

Rebuilds the model as a VanillaTracker from ``cfg.model.backbone`` with
the test_cfg strides/out_indices and a torchvision-layout checkpoint, runs
the dataset, and calls ``dataset.evaluate``. The metric follows the
dataset: ``davis`` (J&F, ``DavisDataset``), ``pck`` (JHMDB pose
propagation, ``JHMDBDataset``) or ``mIoU`` (VIP part segmentation,
``VIPDataset``); ``--options data.test.type=...`` and the ``data.test``
paths pick the dataset.

Usage:
    python -m vfs_tpu_torch.tools.test CONFIG CHECKPOINT \\
        --eval davis|pck|mIoU [--options k=v ...] [--output-dir D] \\
        [--out F] [--device cpu] [--local-devices N|all] \\
        [--launcher none|pytorch]

``--local-devices N`` round-robins the videos over N devices of this
process (N CUDA devices from ``--device`` on, or N workers on the CPU
with ``--device cpu``), one worker thread each. ``--launcher pytorch`` joins
the process group of torchrun's environment (NCCL on CUDA, gloo with
``--device cpu``); each rank evaluates its share of the videos, every
rank gathers all the predictions, and rank 0 computes the metrics. The
bench configuration of the JAX package (bf16 features and backbone,
yuv420 transport) is
``--options test_cfg.pallas_precision=bfloat16
test_cfg.input_format=yuv420 model.backbone.dtype=bfloat16``.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence


def parse_args(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description='Test a tracker')
    parser.add_argument('config', help='config file path')
    parser.add_argument('checkpoint',
                        help='checkpoint (.pth, torchvision layout)')
    parser.add_argument('--eval', nargs='+', default=['davis'],
                        help="metrics: 'davis' (DavisDataset), 'pck' "
                             "(JHMDBDataset) or 'mIoU' (VIPDataset)")
    parser.add_argument('--options', nargs='+', default=None,
                        help='dotted-key config overrides k=v')
    parser.add_argument('--output-dir', default=None,
                        help='dir to save palette PNG predictions')
    parser.add_argument('--out', default=None, help='save raw results (.npz)')
    parser.add_argument('--device', default=None,
                        help="device to run on; CUDA unless given "
                             "(e.g. 'cpu')")
    parser.add_argument('--local-devices', default='1', type=local_devices_arg,
                        help="round-robin videos over N local devices "
                             "('all': every CUDA device); one worker "
                             'thread each')
    parser.add_argument('--launcher', default='none',
                        choices=['none', 'pytorch'],
                        help="'pytorch': torchrun's environment, one "
                             'process a device')
    return parser.parse_args(argv)


def local_devices_arg(v: str) -> str:
    if v != 'all' and not (v.isdigit() and int(v) > 0):
        raise argparse.ArgumentTypeError(
            f"--local-devices must be a positive integer or 'all', got "
            f'{v!r}')
    return v


def local_devices(spec: str, device) -> list:
    """The devices ``--local-devices`` names: ``'all'`` is every CUDA
    device (one CPU); N is N CUDA devices from ``device`` on (``cuda:1``
    and N = 2: ``cuda:1``, ``cuda:2``), or the CPU N times (N worker
    threads) when ``device`` is the CPU."""
    import torch
    if device.type == 'cpu':
        return ['cpu'] * (1 if spec == 'all' else int(spec))
    if spec == 'all':
        return [f'cuda:{i}' for i in range(torch.cuda.device_count())]
    first = device.index or 0
    if first + int(spec) > torch.cuda.device_count():
        raise ValueError(f'--local-devices {spec} from {device}: only '
                         f'{torch.cuda.device_count()} CUDA devices')
    return [f'cuda:{first + i}' for i in range(int(spec))]


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    """Run the eval; returns ``dataset.evaluate``'s results (None on the
    ranks other than 0)."""
    args = parse_args(argv)
    import numpy as np
    import torch

    from ..apis import multi_process_test, single_process_test
    from ..datasets import build_dataset
    from ..device import resolve_device
    from ..models import build_model
    from ..parallel import get_rank, get_world_size, init_dist
    from ..utils import Config, get_root_logger, parse_options

    device_type = torch.device(args.device).type if args.device else 'cuda'
    init_dist(None if args.launcher == 'none' else args.launcher,
              device_type)
    device = resolve_device(args.device)
    cfg = Config.fromfile(args.config)
    if args.options:
        cfg.merge_from_dict(parse_options(args.options))

    logger = get_root_logger()
    dataset = build_dataset(cfg.data.test, dict(test_mode=True))

    # rebuild as VanillaTracker with eval strides (reference
    # tools/test.py:129)
    model_cfg = dict(type='VanillaTracker', backbone=dict(cfg.model.backbone))
    model_cfg['backbone']['pretrained'] = args.checkpoint
    model = build_model(model_cfg, test_cfg=cfg.test_cfg)
    model.init_weights()

    devices = local_devices(args.local_devices, device)
    if get_world_size() > 1:
        results = multi_process_test(model, dataset, device=device)
    elif len(devices) > 1:
        logger.info(f'evaluating over {len(devices)} local devices')
        results = single_process_test(model, dataset, devices=devices)
    else:
        results = single_process_test(model, dataset, device=device)
    if get_rank() != 0:
        return None
    if args.out:
        np.savez(args.out, *[np.asarray(r) for r in results])
        logger.info(f'raw results saved to {args.out}')
    eval_results = dataset.evaluate(results, metrics=args.eval,
                                    output_dir=args.output_dir)
    for name, val in eval_results.items():
        print(f'{name}: {val:.04f}')
    return eval_results


if __name__ == '__main__':
    main()
