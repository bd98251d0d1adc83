"""Convert checkpoints to a torchvision-layout ResNet ``.pth`` (counterpart
of ``tools/convert_weights/convert_to_pretrained.py``; reference:
tools/convert_weights/convert_to_pretrained.py).

    python -m vfs_tpu_torch.tools.convert_to_pretrained SRC DST \\
        [--mode torch|state]

- ``torch``: a reference VFS training checkpoint (``backbone.*`` with
  ConvModule names, ``state_dict`` at the top or not) -> torchvision keys,
  through ``checkpoint.vfs_train_ckpt_to_torchvision``;
- ``state``: a train state ``work_dir/checkpoints/epoch_{n}`` of
  ``tools.train`` (the tracker's ``model`` state dict) -> its backbone
  under torchvision keys, without BatchNorm's ``num_batches_tracked``
  counters: the counterpart of the JAX tool's ``orbax`` mode.

CPU only; the ``.pth`` holds CPU tensors.
"""

from __future__ import annotations

import argparse
from typing import Dict, Mapping, Optional, Sequence

import torch


def state_to_torchvision(model_state: Mapping[str, torch.Tensor]
                         ) -> Dict[str, torch.Tensor]:
    """A tracker's state dict -> its backbone's torchvision-layout state
    dict (the port's ResNet keys are torchvision's below ``backbone.``)."""
    return {k[len('backbone.'):]: v.detach().cpu()
            for k, v in model_state.items() if k.startswith('backbone.')
            and not k.endswith('num_batches_tracked')}


def convert(src: str, dst: str, mode: str = 'torch') -> Dict[str, torch.Tensor]:
    """Convert ``src`` in ``mode`` and ``torch.save`` the result as
    ``dst``; returns it."""
    ckpt = torch.load(src, map_location='cpu', weights_only=False)
    if mode == 'torch':
        from ..checkpoint import vfs_train_ckpt_to_torchvision
        if isinstance(ckpt, dict) and 'state_dict' in ckpt:
            ckpt = ckpt['state_dict']
        out = {k: torch.as_tensor(v)
               for k, v in vfs_train_ckpt_to_torchvision(ckpt).items()}
    elif mode == 'state':
        out = state_to_torchvision(ckpt['model'])
    else:
        raise ValueError(f"mode must be 'torch' or 'state', got {mode!r}")
    if not out:
        raise ValueError(f'{src} holds no backbone weights for mode {mode!r}')
    torch.save(out, dst)
    return out


def parse_args(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(
        description='convert a checkpoint to a torchvision ResNet .pth')
    parser.add_argument('src')
    parser.add_argument('dst')
    parser.add_argument('--mode', choices=['torch', 'state'], default='torch',
                        help="'torch': a reference VFS training ckpt; "
                             "'state': a tools.train epoch_{n} (the JAX "
                             "tool's orbax mode)")
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> str:
    args = parse_args(argv)
    convert(args.src, args.dst, args.mode)
    print(f'converted {args.src} -> {args.dst} ({args.mode})')
    return args.dst


if __name__ == '__main__':
    main()
