"""Tensor helpers (counterpart of ``vfs_tpu/models/common/utils.py``;
reference: mmaction/models/common/utils.py). Videos are channels-last
``(N, T, H, W, C)`` and images ``(N, H, W, C)``, as in the JAX package,
so clip <-> image reshapes are plain reshapes."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn


def video2images(imgs: torch.Tensor) -> torch.Tensor:
    """(N, T, H, W, C) -> (N*T, H, W, C)."""
    n, t = imgs.shape[:2]
    return imgs.reshape(n * t, *imgs.shape[2:])


def images2video(imgs: torch.Tensor, clip_len: int) -> torch.Tensor:
    """(N*T, H, W, C) -> (N, T, H, W, C)."""
    return imgs.reshape(imgs.shape[0] // clip_len, clip_len, *imgs.shape[1:])


def mean_list(tensors):
    """The mean of a list of tensors, summed in list order."""
    out = tensors[0]
    for t in tensors[1:]:
        out = out + t
    return out / len(tensors)


def unmap(data: torch.Tensor, count: int, inds: torch.Tensor,
          fill=0) -> torch.Tensor:
    """Scatter a subset back to the original item count (reference
    common/utils.py:105-116): ``inds`` is a mask of length ``count``; the
    rows of ``data`` land at its true positions, the rest is ``fill``."""
    full = torch.full((count,) + tuple(data.shape[1:]), fill,
                      dtype=data.dtype, device=data.device)
    full[torch.nonzero(torch.as_tensor(inds).bool(), as_tuple=True)[0]] = data
    return full


def clamp(x: torch.Tensor, min=None, max=None) -> torch.Tensor:
    """The reference's ``Clamp`` module (common/utils.py:170-189) as a
    function: ``torch.clamp`` with at least one bound."""
    assert min is not None or max is not None
    return torch.clamp(x, min, max)


def normalize_logit(seg_logit: torch.Tensor) -> torch.Tensor:
    """Channel-wise spatial min-max normalisation, applied only where the
    channel max is positive. Channels-last ``(..., H, W, K)``."""
    smin = torch.amin(seg_logit, dim=(-3, -2), keepdim=True)
    smax = torch.amax(seg_logit, dim=(-3, -2), keepdim=True)
    normalized = (seg_logit - smin) / (smax - smin + 1e-12)
    return torch.where(smax > 0, normalized, seg_logit)


def flax_default_init(module: nn.Module,
                      generator: Optional[torch.Generator] = None) -> None:
    """flax's default initialisers over ``module``: lecun-normal kernels
    (normal truncated at two standard deviations, scaled to a variance of
    1 / fan_in) for convolutions of any rank and linear layers, zero
    biases, BatchNorm scale 1 and shift 0, running statistics reset."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.modules.conv._ConvNd, nn.Linear)):
                fan_in = m.weight[0].numel()
                # flax divides by the truncated normal's standard deviation
                std = math.sqrt(1.0 / fan_in) / .87962566103423978
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.modules.batchnorm._BatchNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.reset_running_stats()


def flax_module_init(module: nn.Module,
                     generator: Optional[torch.Generator] = None) -> None:
    """``flax_default_init``, then each submodule's own initialisers where
    the JAX module gives some (a ``flax_init(generator)`` method: a
    classifier's ``normal(init_std)``, a zero-initialised BatchNorm scale),
    in module order."""
    flax_default_init(module, generator)
    with torch.no_grad():
        for m in module.modules():
            if hasattr(m, 'flax_init'):
                m.flax_init(generator)
