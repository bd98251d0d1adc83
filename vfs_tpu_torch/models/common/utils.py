"""Tensor helpers (counterpart of ``vfs_tpu/models/common/utils.py``)."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn


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
    1 / fan_in) for convolutions and linear layers, zero biases, BatchNorm
    scale 1 and shift 0, running statistics reset."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
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
