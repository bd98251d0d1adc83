"""Frozen operation and byte counts of convolutions of any rank: the
yardstick of the recognizer cells' shares of a peak (``flops.py`` counts
2-D convolutions and linear layers only).

Each ``nn.Conv1d/2d/3d`` and ``nn.Linear`` of a module counts, at the
shapes a forward over meta tensors gives it (no arithmetic runs):
``out.numel() * fan_in`` multiply-accumulates (``fan_in`` the input
channels of a group times the kernel's volume) and, in its tensors'
type, the bytes of its input, its weight and its output, each read or
written once.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple

import torch
import torch.nn as nn

LAYERS = (nn.Conv1d, nn.Conv2d, nn.Conv3d, nn.Linear)


class Work(NamedTuple):
    macs: float
    io_bytes: float         # input read and output written
    weight_bytes: float


def layer_work(module: nn.Module, run: Callable[[nn.Module], None]
               ) -> Dict[str, Work]:
    """Each convolution's and linear layer's ``Work`` in one
    ``run(module)`` (a forward over meta tensors), by module name; a
    layer called more than once adds up."""
    names = {m: name for name, m in module.named_modules()}
    out: Dict[str, Work] = {}

    def hook(m, inp, res):
        if isinstance(m, nn.Linear):
            fan_in = m.in_features
        else:
            fan_in = m.in_channels // m.groups * math.prod(m.kernel_size)
        size = res.element_size()
        done = out.get(names[m], Work(0.0, 0.0, 0.0))
        out[names[m]] = Work(
            done.macs + float(res.numel()) * fan_in,
            done.io_bytes + size * float(inp[0].numel() + res.numel()),
            done.weight_bytes + size * float(m.weight.numel()))

    handles = [m.register_forward_hook(hook) for m in module.modules()
               if isinstance(m, LAYERS)]
    try:
        with torch.no_grad():
            run(module)
    finally:
        for h in handles:
            h.remove()
    return out


def slowfast_work(model: nn.Module, clip_shape, clips: int) -> Dict:
    """The counts of one train step of ``clips`` clips of ``clip_shape``
    (T, H, W, C) through a SlowFast recognizer (``reference.slowfast``'s
    names), counted over one clip on the meta device and scaled:

    - ``macs_per_clip``: the forward's multiply-accumulates;
    - ``step_flops``: 2 FLOPs a multiply-accumulate, x3 for the forward
      and the backward's two products, x2 for the two stems, whose input
      takes no gradient;
    - ``fast`` and ``lateral``: the forward FLOPs and bytes (the
      clips' inputs and outputs, the weights once) of the fast pathway's
      convolutions and of the four laterals'."""
    probe = model.to('meta').eval()
    work = layer_work(probe, lambda m: m(torch.zeros(
        1, 1, *clip_shape, device='meta')))
    stems = ('backbone.slow_path.conv1.conv', 'backbone.fast_path.conv1.conv')
    fwd = sum(w.macs for w in work.values())
    both = sum((2 if name in stems else 3) * w.macs
               for name, w in work.items())

    def part(keep) -> Dict[str, float]:
        chosen = [w for name, w in work.items() if keep(name)]
        return dict(flops=2.0 * clips * sum(w.macs for w in chosen),
                    bytes=sum(clips * w.io_bytes + w.weight_bytes
                              for w in chosen))
    return dict(
        macs_per_clip=fwd, step_flops=2.0 * both * clips,
        fast=part(lambda n: n.startswith('backbone.fast_path.')),
        lateral=part(lambda n: n.startswith('backbone.slow_path.lateral')))
