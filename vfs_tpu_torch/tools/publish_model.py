"""Strip the optimizer state from a checkpoint and stamp its name with the
first 8 hex digits of its sha256, for release (counterpart of
``tools/publish_model.py``; reference: tools/publish_model.py).

    python -m vfs_tpu_torch.tools.publish_model IN OUT

IN is any ``torch.save`` file: a train state ``work_dir/checkpoints/
epoch_{n}`` of ``tools.train`` (``model``, ``optimizer``, ``step``,
``epoch``) or a ``.pth``. Its ``optimizer`` entry is dropped, the rest is
saved as OUT, and OUT is renamed ``OUT_ROOT-{sha8}OUT_EXT``. The JAX
tool's other mode, an orbax train-state directory, has no counterpart:
the port saves no orbax states. CPU only.
"""

from __future__ import annotations

import argparse
import hashlib
import os
from typing import Optional, Sequence


def process_checkpoint(in_file: str, out_file: str) -> str:
    """Save ``in_file``'s contents without ``optimizer`` as ``out_file``."""
    import torch
    ckpt = torch.load(in_file, map_location='cpu', weights_only=False)
    if isinstance(ckpt, dict):
        ckpt.pop('optimizer', None)
    torch.save(ckpt, out_file)
    return out_file


def sha256_of(path: str) -> str:
    """The first 8 hex digits of the file's sha256."""
    h = hashlib.sha256()
    with open(path, 'rb') as f:
        for chunk in iter(lambda: f.read(1 << 20), b''):
            h.update(chunk)
    return h.hexdigest()[:8]


def parse_args(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(
        description='strip the optimizer and sha256-stamp a checkpoint '
                    '(a torch.save file: a tools.train epoch_{n} or a '
                    '.pth; orbax directories are a JAX-package format and '
                    'not read here)')
    parser.add_argument('in_file')
    parser.add_argument('out_file')
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> str:
    args = parse_args(argv)
    if os.path.isdir(args.in_file):
        raise ValueError(f'{args.in_file} is a directory (an orbax train '
                         'state?); this tool reads torch.save files')
    out = process_checkpoint(args.in_file, args.out_file)
    root, ext = os.path.splitext(out)
    final = f'{root}-{sha256_of(out)}{ext}'
    os.replace(out, final)
    print(f'published: {final}')
    return final


if __name__ == '__main__':
    main()
