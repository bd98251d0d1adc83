"""BatchNorm with flax's training semantics (the ``nn.BatchNorm`` of the
JAX package's ``ConvBN``, ``ConvBN3d``, ``MLPBlock`` and heads).

The classes subclass ``nn.BatchNorm1d`` / ``2d`` / ``3d``, so their
parameters and buffers keep torch's names (``weight``, ``bias``,
``running_mean``, ``running_var``, ``num_batches_tracked``) and every
state dict and checkpoint bridge stays valid. In eval mode they are
torch's BatchNorm on the running statistics. In training mode they follow
flax, where torch differs:

- the batch statistics are computed in fp32 (or the input's type, if
  wider) as ``E[x^2] - E[x]^2``, clipped at 0 (flax ``_compute_stats``
  with ``use_fast_variance``); torch takes ``E[(x - E[x])^2]``;
- the running variance takes the *biased* batch variance, as
  ``0.9 * old + (1 - 0.9) * new`` (flax momentum 0.9); torch stores the
  unbiased one, which at a batch of N differs by N / (N - 1);
- the output is ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in
  that type, cast back to the input's (bf16 under autocast); as in flax,
  the statistics and the normalisation each cast the input apart, so a
  bf16 input's gradient is the bf16 sum of two bf16-rounded parts.

With a ``process_group`` the per-channel sums, sums of squares and counts
are all-reduced through ``torch.distributed.nn.functional.all_reduce``,
whose backward all-reduces the gradient: the statistics are those of the
global batch and the gradient is that of the global loss (SyncBN; what
GSPMD gives the JAX package for free).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn as nn

# flax's momentum: running = FLAX_MOMENTUM * running + (1 - FLAX_MOMENTUM)
# * batch statistic
FLAX_MOMENTUM = 0.9


class _FlaxBatchNorm:
    """Training-mode forward shared by the 1-d, 2-d and 3-d classes (the
    channel axis is 1 in all)."""

    process_group = None
    # flax's momentum; the SiamFC AlexNets' BatchNorm takes 0.95
    flax_momentum = FLAX_MOMENTUM
    # False while a checkpointed block recomputes its forward in the
    # backward pass: the running statistics were updated once already
    update_stats = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        dims = [d for d in range(x.dim()) if d != 1]
        # at least fp32, as flax promotes (fp64 stays fp64)
        wide = torch.promote_types(x.dtype, torch.float32)
        xf = x.to(wide)
        count = torch.full((1,), float(x.numel() // x.shape[1]),
                           dtype=wide, device=x.device)
        sums = torch.cat([xf.sum(dims), (xf * xf).sum(dims), count])
        if self.process_group is not None:
            from torch.distributed.nn.functional import all_reduce
            sums = all_reduce(sums, group=self.process_group)
        c = x.shape[1]
        n = sums[2 * c]
        mean = sums[:c] / n
        var = torch.clamp(sums[c:2 * c] / n - mean * mean, min=0.0)
        if self.update_stats and self.track_running_stats:
            with torch.no_grad():
                m = self.flax_momentum
                self.running_mean.copy_(m * self.running_mean
                                        + (1 - m) * mean.detach())
                self.running_var.copy_(m * self.running_var
                                       + (1 - m) * var.detach())
                self.num_batches_tracked.add_(1)
        shape = [1] * x.dim()
        shape[1] = c
        mul = torch.rsqrt(var + self.eps)
        if self.affine:
            mul = mul * self.weight.to(wide)
        # a cast of its own, as flax casts once for the statistics and
        # once here: under bf16 the two parts of the input's gradient are
        # each rounded to bf16 and added in bf16, as in the JAX package
        y = (x.to(wide) - mean.view(shape)) * mul.view(shape)
        if self.affine:
            y = y + self.bias.to(wide).view(shape)
        return y.to(x.dtype)


class BatchNorm1d(_FlaxBatchNorm, nn.BatchNorm1d):
    """(N, C) BatchNorm with flax's training semantics."""


class BatchNorm2d(_FlaxBatchNorm, nn.BatchNorm2d):
    """(N, C, H, W) BatchNorm with flax's training semantics."""


class BatchNorm3d(_FlaxBatchNorm, nn.BatchNorm3d):
    """(N, C, T, H, W) BatchNorm with flax's training semantics (the 3-D
    recognition backbones)."""


class NormEvalModule(nn.Module):
    """A backbone whose ``norm_eval`` keeps every BatchNorm on its running
    statistics in training mode."""
    norm_eval = False

    def train(self, mode: bool = True):
        super().train(mode)
        if mode and self.norm_eval:
            for m in self.modules():
                if isinstance(m, nn.modules.batchnorm._BatchNorm):
                    m.eval()
        return self


def set_sync_group(module: nn.Module, group) -> None:
    """Compute every flax-semantics BatchNorm's statistics over the
    processes of ``group`` (``None``: this process's batch only)."""
    for m in module.modules():
        if isinstance(m, _FlaxBatchNorm):
            m.process_group = group


@contextlib.contextmanager
def frozen_running_stats(module: nn.Module):
    """Leave the running statistics of ``module``'s BatchNorms alone inside
    the block: the recomputation of a checkpointed forward runs here, so
    that one training step updates them once, as the JAX package's remat
    does."""
    norms = [m for m in module.modules() if isinstance(m, _FlaxBatchNorm)]
    for m in norms:
        m.update_stats = False
    try:
        yield
    finally:
        for m in norms:
            m.update_stats = True
