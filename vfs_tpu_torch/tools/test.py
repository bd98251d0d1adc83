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
        [--out F] [--device cpu]
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
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    """Run the eval; returns ``dataset.evaluate``'s results."""
    args = parse_args(argv)
    import numpy as np

    from ..apis import single_process_test
    from ..datasets import build_dataset
    from ..device import resolve_device
    from ..models import build_model
    from ..utils import Config, get_root_logger, parse_options

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

    results = single_process_test(model, dataset, device=device)
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
