"""Affinity helpers (PyTorch counterpart of ``vfs_tpu/ops/affinity.py``).

Layouts follow the JAX package: feature maps are channels-last
``(..., H, W, C)``.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

# the masked-score fill: finite, so softmax gives masked keys weight 0
# without producing NaN rows
NEG_INF = -1e30


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    """``x / max(||x||, eps)`` along ``dim`` (torch F.normalize semantics,
    written out so the arithmetic matches the JAX package's)."""
    norm = torch.sqrt(torch.sum(x * x, dim=dim, keepdim=True))
    return x / torch.clamp(norm, min=eps)


def spatial_neighbor(height: int,
                     width: int,
                     neighbor_range: Union[int, Tuple[int, int]],
                     mode: str = 'circle',
                     transpose: bool = False,
                     device: Optional[torch.device] = None) -> torch.Tensor:
    """Boolean spatial-neighbourhood mask ``(H*W, H*W)`` indexed
    ``[key_pos, query_pos]``. ``'circle'``: Euclidean distance (fp32)
    ``< neighbor_range // 2``; ``'square'``: ``|dy| <= nr_h // 2`` and
    ``|dx| <= nr_w // 2``."""
    assert mode in ('circle', 'square')
    ky, kx = torch.meshgrid(torch.arange(height, device=device),
                            torch.arange(width, device=device),
                            indexing='ij')
    ky = ky.reshape(-1)
    kx = kx.reshape(-1)
    dy = ky[:, None] - ky[None, :]
    dx = kx[:, None] - kx[None, :]
    if mode == 'circle':
        radius = neighbor_range // 2
        dist = torch.sqrt(dy.float()**2 + dx.float()**2)
        mask = dist < radius
    else:
        if isinstance(neighbor_range, int):
            nr_h = nr_w = neighbor_range
        else:
            nr_h, nr_w = neighbor_range
        mask = (dy.abs() <= nr_h // 2) & (dx.abs() <= nr_w // 2)
    if transpose:
        mask = mask.T
    return mask
