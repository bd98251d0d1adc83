"""SiamFC cross-correlation heads (PyTorch counterpart of
``siamfc_tpu/heads.py``).

Reference: projects/siamfc-pytorch/siamfc/heads.py:7-58. The interface is
channels-last, as the port's ResNet gives its maps: ``(N, H, W, C)`` in,
``(N, h, w, 1)`` responses out. Inside, the convolutions run on the NCHW
view of the same memory.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


def fast_xcorr(z: torch.Tensor, x: torch.Tensor,
               out_scale: float) -> torch.Tensor:
    """Grouped cross-correlation.

    Args:
        z: (Nz, hz, wz, C) exemplar features (the kernel).
        x: (Nx, hx, wx, C) search features; Nx must be a multiple of Nz.
            Row ``b * Nz + j`` pairs with kernel ``j`` (the JAX package's
            pairing; the trackers flatten their crops scale-major).
    Returns:
        (Nx, hx-hz+1, wx-wz+1, 1) response maps.
    """
    nz, hz, wz, c = z.shape
    nx, hx, wx, _ = x.shape
    # fold the pair axis into channels: (Nx/Nz, hx, wx, Nz*C), then its
    # NCHW view; group j holds channels [j*C, (j+1)*C)
    lhs = x.reshape(nx // nz, nz, hx, wx, c).permute(0, 2, 3, 1, 4)
    lhs = lhs.reshape(nx // nz, hx, wx, nz * c).permute(0, 3, 1, 2)
    out = F.conv2d(lhs, z.permute(0, 3, 1, 2), groups=nz)
    # (Nx/Nz, Nz, h', w') -> (Nx, h', w', 1)
    out = out.reshape(nx, out.shape[-2], out.shape[-1], 1)
    return out * out_scale


def flax_conv_init_(conv: nn.Conv2d,
                    generator: Optional[torch.Generator] = None) -> None:
    """flax ``nn.Conv``'s default initialisers: the kernel from
    ``lecun_normal`` (a normal truncated at two standard deviations, fan
    in, scaled to unit variance), the bias zero."""
    fan_in = conv.in_channels * conv.kernel_size[0] * conv.kernel_size[1]
    std = math.sqrt(1.0 / fan_in) / .87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(conv.weight, 0.0, std, -2 * std, 2 * std,
                              generator=generator)
        if conv.bias is not None:
            conv.bias.zero_()


class SiamFC(nn.Module):
    """Parameter-free xcorr head (reference heads.py:7-23)."""

    def __init__(self, out_scale: float = 0.001):
        super().__init__()
        self.out_scale = out_scale

    def init_weights(self, generator: Optional[torch.Generator] = None):
        pass

    def forward(self, z, x):
        return fast_xcorr(z, x, self.out_scale)


class SiamConvFC(nn.Module):
    """xcorr with 1x1 conv branches on z and x (the linear-probe 'extra
    conv'; reference heads.py:26-58). Parameters ``z_conv{i}`` /
    ``x_conv{i}`` with bias, as the JAX head's."""

    def __init__(self, in_channels: int, channels: int, num_convs: int = 1,
                 kernel_size: int = 1, out_scale: float = 0.001):
        super().__init__()
        self.num_convs = num_convs
        self.out_scale = out_scale
        for i in range(num_convs):
            cin = in_channels if i == 0 else channels
            self.add_module(f'z_conv{i}', nn.Conv2d(cin, channels,
                                                    kernel_size))
            self.add_module(f'x_conv{i}', nn.Conv2d(cin, channels,
                                                    kernel_size))

    def init_weights(self, generator: Optional[torch.Generator] = None):
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                flax_conv_init_(m, generator)

    @staticmethod
    def _conv(conv, t):
        return conv(t.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    def forward(self, z, x):
        for i in range(self.num_convs):
            z = self._conv(getattr(self, f'z_conv{i}'), z)
            x = self._conv(getattr(self, f'x_conv{i}'), x)
        return fast_xcorr(z, x, self.out_scale)
