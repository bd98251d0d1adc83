"""The precision a reference computes in: ``'fp32'`` (TF32 off, the
configurations' own) or ``'tf32'`` (the control: TF32 products and
convolutions, the nearest precision below fp32)."""

from __future__ import annotations

import contextlib

import torch

PRECISIONS = ('fp32', 'tf32')


@contextlib.contextmanager
def matmul_precision(precision: str):
    """cuBLAS and cuDNN TF32 flags for ``precision``, restored after."""
    if precision not in PRECISIONS:
        raise ValueError(f'precision {precision!r}: one of {PRECISIONS}')
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    tf32 = precision == 'tf32'
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
