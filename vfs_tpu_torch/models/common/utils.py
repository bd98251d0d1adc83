"""Tensor helpers (counterpart of ``vfs_tpu/models/common/utils.py``)."""

from __future__ import annotations

import torch


def normalize_logit(seg_logit: torch.Tensor) -> torch.Tensor:
    """Channel-wise spatial min-max normalisation, applied only where the
    channel max is positive. Channels-last ``(..., H, W, K)``."""
    smin = torch.amin(seg_logit, dim=(-3, -2), keepdim=True)
    smax = torch.amax(seg_logit, dim=(-3, -2), keepdim=True)
    normalized = (seg_logit - smin) / (smax - smin + 1e-12)
    return torch.where(smax > 0, normalized, seg_logit)
