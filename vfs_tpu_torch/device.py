"""Device choice and the exact fp32 mode.

Entry points run on CUDA unless the caller asks for the CPU. With no GPU
and no explicit ``device='cpu'`` they raise; they never fall back to the
CPU quietly.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the current CUDA device, which must exist."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                'vfs_tpu_torch runs on a CUDA device by default and none is '
                "available; pass device='cpu' to run on the CPU")
        return torch.device('cuda', torch.cuda.current_device())
    return torch.device(device)


@contextlib.contextmanager
def exact_fp32():
    """fp32 matmuls and cuDNN convolutions without TF32 (which keeps ~3
    decimal digits and can flip top-k selections); flags restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def to_channels_last(module: torch.nn.Module) -> torch.nn.Module:
    """Give ``module``'s 4-D parameters and buffers the channels_last
    memory format and its 5-D ones channels_last_3d (cuDNN's NHWC and NDHWC
    convolutions); the others stay as they are."""
    formats = {4: torch.channels_last, 5: torch.channels_last_3d}
    for t in list(module.parameters()) + list(module.buffers()):
        if t.dim() in formats:
            t.data = t.data.contiguous(memory_format=formats[t.dim()])
    return module
