"""Parameters and FLOPs of a config's backbone (counterpart of
``tools/analysis/get_flops.py``), for one input: a frame for the port's
``ResNet`` (NHWC), ``--frames`` frames for a 2-D recognition backbone
(NCHW; by default its ``num_segments``), a clip of ``--frames`` frames for
a 3-D one (NCTHW; by default 8).

Parameters: every learnable tensor of the backbone (BatchNorm statistics
are buffers, not parameters), the same count as the JAX package's
``variables['params']``. FLOPs: ``torch.utils.flop_counter
.FlopCounterMode`` over one forward at ``(1, H, W, 3)``, 2 per
multiply-add of the convolutions and matrix products. XLA's cost
analysis, which the JAX tool prints, counts the compiled graph by its own
rules, elementwise operations among them, and is not the yardstick: for
the r18 config at 224x224 it gives 3.37 GFLOP against 3.63 here (both on
the CPU; the parameter counts are equal, 11,176,512).

Usage:
    python -m vfs_tpu_torch.tools.analysis.get_flops CONFIG
        [--shape 224 224] [--frames N] [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence, Tuple

import torch

from ...device import resolve_device
from ...models import build_backbone
from ...models.backbones import ResNet
from ...models.common import flax_module_init
from ...utils import Config
from .common import add_device_arg


def parse_args(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description='params and FLOPs')
    parser.add_argument('config')
    parser.add_argument('--shape', type=int, nargs='+', default=[224, 224])
    parser.add_argument('--frames', type=int, default=None,
                        help='frames of a recognition backbone\'s input')
    add_device_arg(parser)
    return parser.parse_args(argv)


def input_shape(backbone, h: int, w: int, frames: Optional[int] = None
                ) -> Tuple[int, ...]:
    """The shape of one input of ``backbone`` (module docstring)."""
    if isinstance(backbone, ResNet):
        return (1, h, w, 3)
    if any(isinstance(m, torch.nn.Conv3d) for m in backbone.modules()):
        return (1, 3, frames or 8, h, w)
    return (frames or getattr(backbone, 'num_segments', 1), 3, h, w)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    from torch.utils.flop_counter import FlopCounterMode
    device = resolve_device(args.device)
    cfg = Config.fromfile(args.config)
    backbone = build_backbone(dict(cfg.model.backbone))
    generator = torch.Generator().manual_seed(0)
    if hasattr(backbone, 'init_weights'):
        backbone.init_weights(generator)
    else:  # the recognition backbones take the JAX modules' initialisers
        with torch.no_grad():
            flax_module_init(backbone, generator)
    backbone.to(device).eval()
    h, w = args.shape if len(args.shape) == 2 else (args.shape[0],) * 2
    n_params = sum(p.numel() for p in backbone.parameters())
    shape = input_shape(backbone, h, w, args.frames)
    x = torch.zeros(shape, dtype=torch.float32, device=device)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        backbone(x)
    flops = float(counter.get_total_flops())
    print(f'Input shape: {shape}')
    print(f'Params: {n_params / 1e6:.2f} M ({n_params})')
    print(f'FLOPs: {flops / 1e9:.2f} GFLOPs (FlopCounterMode: convolutions '
          'and matrix products, 2 per multiply-add)')
    return dict(shape=list(shape), params=n_params, flops=flops)


if __name__ == '__main__':
    main()
