"""Seeded weights, made on the run's device in two large draws from a
generator seeded by ``--seed``, in fp32, under the names of the
reference's state dict (torchvision's, which the program's models keep),
so that the program and the reference load the same numbers.

Rules (a configuration's ``weights`` key names one):

- ``flax_init``: the program's training initialisation (flax's
  defaults): convolution and linear kernels from a normal truncated at
  two standard deviations with variance 1 / fan_in, zero biases,
  BatchNorm scale 1 and shift 0, and each residual block's last
  BatchNorm scale 0 (``zero_init_residual``);
- ``kaiming_random_bn``: convolutions normal with variance 2 / fan_out
  (the ResNet's own init), every BatchNorm scale 1 + 0.1 N(0, 1) and
  shift 0.1 N(0, 1), so that no residual block is the identity (seeded
  random weights for an eval).

Running statistics start at mean 0 and variance 1 in both.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn as nn

# flax's truncated normal is divided by its own standard deviation
TRUNC_STD = 0.87962566103423978


def _kinds(model: nn.Module) -> Dict[str, str]:
    """The kind of each state-dict entry of ``model``: 'conv', 'linear',
    'bias', 'bn_weight', 'last_bn_weight', 'bn_bias', 'mean', 'var',
    'count'."""
    last_bns = set()
    for name, m in model.named_modules():
        for bn in ('bn3', 'bn2'):
            if hasattr(m, bn) and hasattr(m, 'conv1') \
                    and hasattr(m, 'downsample'):
                last_bns.add(f'{name}.{bn}' if name else bn)
                break
    kinds = {}
    for name, m in model.named_modules():
        prefix = f'{name}.' if name else ''
        if isinstance(m, nn.Conv2d):
            kinds[prefix + 'weight'] = 'conv'
        elif isinstance(m, nn.Linear):
            kinds[prefix + 'weight'] = 'linear'
            kinds[prefix + 'bias'] = 'bias'
        elif hasattr(m, 'running_mean'):
            kinds[prefix + 'weight'] = ('last_bn_weight' if name in last_bns
                                        else 'bn_weight')
            kinds[prefix + 'bias'] = 'bn_bias'
            kinds[prefix + 'running_mean'] = 'mean'
            kinds[prefix + 'running_var'] = 'var'
            kinds[prefix + 'num_batches_tracked'] = 'count'
    return kinds


def seeded_state(model: nn.Module, rule: str, seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """The state dict of ``rule`` (module docstring) for ``model``'s
    shapes, on ``device``, from ``seed``."""
    if rule not in ('flax_init', 'kaiming_random_bn'):
        raise KeyError(f'unknown weight rule {rule!r}')
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    kinds = _kinds(model)
    missing = sorted(set(shapes) - set(kinds))
    if missing:
        raise KeyError(f'no weight kind for {missing[:4]}')
    random = [k for k in shapes if kinds[k] in (
        ('conv', 'linear') if rule == 'flax_init'
        else ('conv', 'bn_weight', 'last_bn_weight', 'bn_bias'))]
    total = sum(math.prod(shapes[k]) for k in random)
    generator = torch.Generator(device=device)
    generator.manual_seed(int(seed))
    if rule == 'flax_init':
        # a normal truncated at +-2 by its inverse CDF, in one draw
        lo = 0.5 * math.erfc(2 / math.sqrt(2))
        u = torch.rand(total, generator=generator, device=device)
        draws = math.sqrt(2) * torch.erfinv(2 * (lo + u * (1 - 2 * lo)) - 1)
    else:
        draws = torch.randn(total, generator=generator, device=device)
    state, at = {}, 0
    for key, shape in shapes.items():
        kind = kinds[key]
        if key in random:
            n = math.prod(shape)
            x = draws[at:at + n].view(shape)
            at += n
            if kind in ('conv', 'linear'):
                if rule == 'flax_init':
                    fan_in = math.prod(shape[1:])
                    x = x * (math.sqrt(1.0 / fan_in) / TRUNC_STD)
                else:
                    fan_out = shape[0] * math.prod(shape[2:])
                    x = x * math.sqrt(2.0 / fan_out)
            elif kind in ('bn_weight', 'last_bn_weight'):
                x = 1.0 + 0.1 * x
            else:
                x = 0.1 * x
            state[key] = x
        elif kind == 'count':
            state[key] = torch.zeros((), dtype=torch.long, device=device)
        else:
            fill = {'bias': 0.0, 'bn_bias': 0.0, 'mean': 0.0, 'var': 1.0,
                    'bn_weight': 1.0, 'last_bn_weight': 0.0}[kind]
            state[key] = torch.full(shape, fill, dtype=torch.float32,
                                    device=device)
    return state
