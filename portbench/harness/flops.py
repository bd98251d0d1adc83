"""Frozen operation counts: the yardstick of every share of a peak.

- ``module_macs``: the multiply-accumulates of every convolution and
  linear layer of a module at the shapes a forward gives them, counted
  with hooks over meta tensors (no arithmetic runs);
- ``train_flops``: one SimSiam train step (the count of the port's
  ``chip_smoke.train_flops``): 2 FLOPs a multiply-accumulate of the
  forward over both views, x3 for the forward and the two backward
  products, x2 for the stem's convolution, whose input takes no gradient;
- ``row1_work``: the operations and bytes that row 1 (the masked
  windowed top-k affinity of a video) needs for a video's shapes: 2*C
  per (query, distinct live bank frame, in-map key in the circle),
  features read once and the top-k scores and sources written once.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch
import torch.nn as nn


def module_macs(module: nn.Module, run: Callable[[nn.Module], None],
                stem: nn.Module = None) -> Tuple[float, float]:
    """(forward MACs, MACs of forward plus backward) of ``run(module)``,
    which drives a forward over meta tensors. Each convolution and linear
    layer counts ``out.numel() * fan_in`` a call; the backward passes
    count twice that, except at ``stem``, whose input takes no gradient
    (once)."""
    macs = [0.0, 0.0]

    def hook(m, inp, out):
        if isinstance(m, nn.Conv2d):
            fan_in = (m.in_channels // m.groups * m.kernel_size[0]
                      * m.kernel_size[1])
        else:
            fan_in = m.in_features
        n = float(out.numel()) * fan_in
        macs[0] += n
        macs[1] += (2 if m is stem else 3) * n

    handles = [m.register_forward_hook(hook) for m in module.modules()
               if isinstance(m, (nn.Conv2d, nn.Linear))]
    try:
        with torch.no_grad():
            run(module)
    finally:
        for h in handles:
            h.remove()
    return macs[0], macs[1]


def train_flops(model: nn.Module, frames_hw: Tuple[int, int],
                n_frames: int) -> float:
    """FLOPs of one train step over ``n_frames`` frames (both views) of
    ``frames_hw``: ``model`` is the reference SimSiam model, counted over
    one sample of two one-frame views on the meta device and scaled."""
    probe = model.to('meta').eval()
    _, both = module_macs(
        probe, lambda m: m(torch.zeros(1, 2, 1, *frames_hw, 3,
                                       device='meta')),
        stem=probe.backbone.conv1)
    return 2.0 * both * n_frames / 2


def forward_flops(model: nn.Module, x_shape: Tuple[int, ...]) -> float:
    """FLOPs (2 a MAC) of one forward of ``model`` on a meta tensor of
    ``x_shape``."""
    probe = model.to('meta').eval()
    fwd, _ = module_macs(probe, lambda m: m(torch.zeros(*x_shape,
                                                        device='meta')))
    return 2.0 * fwd


def circle_offsets(radius: float) -> Tuple[np.ndarray, np.ndarray]:
    """Window offsets (dy, dx) with ``dy^2 + dx^2 < radius^2``."""
    r = int(np.ceil(radius - 1))
    d = np.arange(-r, r + 1)
    dy, dx = np.meshgrid(d, d, indexing='ij')
    keep = (dy.astype(np.float64) ** 2 + dx ** 2) < radius * radius
    return dy[keep], dx[keep]


def window_pairs(h: int, w: int, radius: float) -> int:
    """(query, key) pairs of one frame pair: keys in the circle and in the
    map."""
    dy, dx = circle_offsets(radius)
    ys = np.arange(h)[:, None, None] + dy
    xs = np.arange(w)[None, :, None] + dx
    return int(((ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)).sum())


def live_frames(t_total: int, precede: int) -> int:
    """Distinct bank frames over a video's query frames: frame t scores
    frame 0 and the ``precede`` frames before it, min(t, precede + 1)
    distinct ones (frame 0 is in two slots while t <= precede)."""
    return sum(min(t, precede + 1) for t in range(1, t_total))


def row1_work(t_total: int, h: int, w: int, c: int, radius: float,
              topk: int, precede: int) -> Dict[str, float]:
    """Row 1's operations and bytes for one video (module docstring)."""
    flops = 2.0 * c * window_pairs(h, w, radius) * live_frames(t_total,
                                                               precede)
    nbytes = (4.0 * t_total * h * w * c
              + 12.0 * (t_total - 1) * h * w * topk)
    return dict(flops=flops, bytes=nbytes)


def roofline_seconds(work: Dict[str, float], fp32_flops: float,
                     bytes_per_s: float) -> float:
    """The least time the card could take: the larger of the operations
    over the fp32 peak and the bytes over the memory bandwidth."""
    return max(work['flops'] / fp32_flops, work['bytes'] / bytes_per_s)
