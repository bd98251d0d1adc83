"""Non-local block (counterpart of ``vfs_tpu/models/common/non_local.py``;
mmcv's ``NonLocal3d`` as the reference backbones use it: resnet3d.py
per block, resnet_tsm.py:10-37 over a 2-D batch through ``NL3DWrapper``).

NCTHW in and out. ``g``, ``theta`` and ``phi`` are 1x1x1 convolutions to
``in_channels // reduction`` channels with biases; ``conv_out`` goes back
to ``in_channels``, with a BatchNorm (``with_norm``, no bias on the conv)
or a bias, and no activation. The attention runs over the (T, H, W)
positions flattened in that order, as mmcv's ``view(n, c, -1)`` and the
JAX package's channels-last reshape both do. Pairwise modes:
``gaussian`` (softmax of the raw dot of x), ``embedded_gaussian`` (softmax
of theta . phi, over sqrt(inter) with ``use_scale``), ``dot_product``
(theta . phi over the number of keys) and ``concatenation`` (ReLU of a 1x1
projection of [theta; phi], over the number of keys). ``sub_sample``
max-pools the keys and values 2x2 in space. The output is ``x +
conv_out(y)``; with ``zeros_init`` the block starts as the identity (the
norm's scale, or the unnormed conv, starts at zero).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from .norm import BatchNorm3d

MODES = ('gaussian', 'embedded_gaussian', 'dot_product', 'concatenation')


def non_local_kwargs(cfg) -> dict:
    """A ``non_local_cfg`` -> ``NonLocal3d``'s arguments, with the JAX
    package's defaults; a ``norm_cfg`` gives ``conv_out`` its norm."""
    cfg = dict(cfg or {})
    return dict(reduction=cfg.get('reduction', 2),
                use_scale=cfg.get('use_scale', True),
                mode=cfg.get('mode', 'embedded_gaussian'),
                sub_sample=cfg.get('sub_sample', False),
                with_norm=cfg.get('norm_cfg') is not None,
                zeros_init=cfg.get('zeros_init', True))


class NonLocal3d(nn.Module):

    def __init__(self, in_channels: int, reduction: int = 2,
                 use_scale: bool = True, mode: str = 'embedded_gaussian',
                 sub_sample: bool = False, with_norm: bool = True,
                 zeros_init: bool = True):
        super().__init__()
        if mode not in MODES:
            raise ValueError(f'unsupported non-local mode {mode!r}')
        self.in_channels = in_channels
        self.inter = max(in_channels // reduction, 1)
        self.use_scale = use_scale
        self.mode = mode
        self.sub_sample = sub_sample
        self.with_norm = with_norm
        self.zeros_init = zeros_init
        self.g = nn.Conv3d(in_channels, self.inter, 1)
        if mode != 'gaussian':
            self.theta = nn.Conv3d(in_channels, self.inter, 1)
            self.phi = nn.Conv3d(in_channels, self.inter, 1)
        if mode == 'concatenation':
            self.concat_project = nn.Conv2d(2 * self.inter, 1, 1, bias=False)
        self.conv_out = nn.Conv3d(self.inter, in_channels, 1,
                                  bias=not with_norm)
        if with_norm:
            self.norm = BatchNorm3d(in_channels, eps=1e-5)

    def flax_init(self, generator=None):
        for name in ('g', 'theta', 'phi', 'concat_project'):
            if hasattr(self, name):
                getattr(self, name).weight.normal_(0.0, 0.01,
                                                   generator=generator)
        if self.zeros_init and not self.with_norm:
            self.conv_out.weight.zero_()
        else:
            self.conv_out.weight.normal_(0.0, 0.01, generator=generator)
        if self.with_norm and self.zeros_init:
            self.norm.weight.zero_()

    def _keys(self, v):
        """(n, c, t, h, w) -> (n, positions, c), 2x2 max-pooled in space
        with ``sub_sample``."""
        if self.sub_sample:
            v = F.max_pool3d(v, (1, 2, 2), (1, 2, 2))
        return v.flatten(2).transpose(1, 2)

    def forward(self, x):
        n, c, t, h, w = x.shape
        g_x = self._keys(self.g(x))                           # (n, k, i)
        if self.mode == 'gaussian':
            pairwise = torch.softmax(torch.bmm(
                x.flatten(2).transpose(1, 2), self._keys(x).transpose(1, 2)),
                dim=-1)
        else:
            theta_x = self.theta(x).flatten(2).transpose(1, 2)  # (n, q, i)
            phi_x = self._keys(self.phi(x))                     # (n, k, i)
            nk = phi_x.shape[1]
            if self.mode == 'concatenation':
                wp = self.concat_project.weight.reshape(2, self.inter)
                pairwise = F.relu(
                    (theta_x @ wp[0])[:, :, None]
                    + (phi_x @ wp[1])[:, None, :]) / nk
            else:
                pairwise = torch.bmm(theta_x, phi_x.transpose(1, 2))
                if self.mode == 'embedded_gaussian':
                    if self.use_scale:
                        pairwise = pairwise / math.sqrt(self.inter)
                    pairwise = torch.softmax(pairwise, dim=-1)
                else:
                    pairwise = pairwise / nk
        y = torch.bmm(pairwise, g_x).transpose(1, 2).reshape(
            n, self.inter, t, h, w)
        out = self.conv_out(y)
        if self.with_norm:
            out = self.norm(out)
        return x + out


class NL3DWrapper(nn.Module):
    """``NonLocal3d`` over a 2-D batch of ``num_segments`` frames a clip:
    (N*seg, C, H, W) in and out (reference resnet_tsm.py:10-37)."""

    def __init__(self, in_channels: int, num_segments: int, **kwargs):
        super().__init__()
        self.num_segments = num_segments
        self.non_local_block = NonLocal3d(in_channels, **kwargs)

    def forward(self, x):
        nt, c, h, w = x.shape
        v = x.reshape(nt // self.num_segments, self.num_segments, c, h, w)
        v = self.non_local_block(v.transpose(1, 2))
        return v.transpose(1, 2).reshape(nt, c, h, w)
