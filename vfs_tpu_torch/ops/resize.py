"""Resize ops (PyTorch counterpart of ``vfs_tpu/ops/resize.py``).

- ``resize_bilinear``: half-pixel centres, the semantics of
  ``F.interpolate(mode='bilinear', align_corners=False)`` when upsampling
  or downsampling by at most 2x, and of the JAX package's antialiased
  ``jax.image.resize(method='linear')`` below that. Both are separable
  matrix products, channels-last.
- ``pil_nearest_resize`` is host-side: PIL's NEAREST grid differs from
  torch's and must be bit-matched for J&F parity.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _linear_resize_matrix(n_out: int, n_in: int) -> np.ndarray:
    """(n_out, n_in) 2-tap bilinear matrix, half-pixel centres with edge
    clamping."""
    scale = n_in / n_out
    pos = (np.arange(n_out) + 0.5) * scale - 0.5
    lo = np.floor(pos).astype(np.int64)
    frac = pos - lo
    hi = np.clip(lo + 1, 0, n_in - 1)
    lo = np.clip(lo, 0, n_in - 1)
    mat = np.zeros((n_out, n_in), np.float32)
    rows = np.arange(n_out)
    np.add.at(mat, (rows, lo), 1.0 - frac)
    np.add.at(mat, (rows, hi), frac)
    return mat


def _antialias_resize_matrix(n_out: int, n_in: int) -> np.ndarray:
    """(n_out, n_in) triangle-filter matrix for downsampling: the kernel
    widens by the scale factor and each row is normalised, as in
    ``jax.image.resize(method='linear', antialias=True)``. Computed in
    float32 like the JAX weights."""
    f32 = np.float32
    inv_scale = f32(1.0) / f32(f32(n_out) / f32(n_in))
    kernel_scale = max(inv_scale, f32(1.0))
    sample = ((np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale
              - f32(0.5))
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) \
        / kernel_scale
    weights = np.maximum(f32(0.0), f32(1.0) - x)
    total = weights.sum(axis=0, keepdims=True)
    weights = np.where(np.abs(total) > 1000. * np.finfo(f32).eps,
                       weights / np.where(total != 0, total, f32(1.0)),
                       f32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    weights = np.where(inside[None, :], weights, f32(0.0))
    return np.ascontiguousarray(weights.T, dtype=f32)


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of ``(N, H, W, C)`` to ``(N, *size, C)``."""
    n, h, w, c = x.shape
    if (h, w) == tuple(size):
        return x
    make = (_antialias_resize_matrix
            if size[0] * 2 < h or size[1] * 2 < w else _linear_resize_matrix)
    ry = torch.from_numpy(make(size[0], h)).to(x.device)
    rx = torch.from_numpy(make(size[1], w)).to(x.device)
    x = x.to(torch.float32)
    # contract the cheaper axis first (same weights either way)
    if size[0] * w * (h + size[1]) <= h * size[1] * (w + size[0]):
        out = torch.einsum('oh,nhwc->nowc', ry, x)
        return torch.einsum('pw,nowc->nopc', rx, out)
    out = torch.einsum('pw,nhwc->nhpc', rx, x)
    return torch.einsum('oh,nhpc->nopc', ry, out)


def resize_nearest(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Nearest resize of ``(N, H, W, C)`` matching torch
    ``F.interpolate(mode='nearest')`` (src index = floor(dst * scale))."""
    n, h, w, c = x.shape
    if (h, w) == tuple(size):
        return x
    rows = torch.floor(torch.arange(size[0], dtype=torch.float32)
                       * (h / size[0])).long().clamp(0, h - 1)
    cols = torch.floor(torch.arange(size[1], dtype=torch.float32)
                       * (w / size[1])).long().clamp(0, w - 1)
    return x[:, rows.to(x.device)][:, :, cols.to(x.device)]


def pil_nearest_resize(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Host-side PIL NEAREST resize of a 2-D array to ``size=(H, W)``."""
    from PIL import Image
    dtype = img.dtype
    pil = Image.fromarray(np.ascontiguousarray(img.astype(np.float32)))
    resized = pil.resize((size[1], size[0]), resample=Image.NEAREST)
    return np.asarray(resized).astype(dtype)
