"""Plain SlowFast training (Feichtenhofer et al., "SlowFast Networks for
Video Recognition", ICCV 2019, arXiv 1812.03982) as MMAction2 v0.6.0
configures it (``resnet3d_slowfast.py``, ``slowfast_head.py``,
``slowfast_r50_4x16x1_256e_kinetics400_rgb.py``): the reference of the
recognizer train cell. Names as the program's state dict has them, so
that one seeded state loads into both.

- input: (N, clips, T, H, W, C) clips, the clips folded into the batch
  and permuted to (N, C, T, H, W);
- slow pathway: frames 0, r, 2r, ... (``resample_rate`` r; MMAction2's
  nearest-neighbour resize by 1 / r picks the same frames); fast
  pathway: every ``r // speed_ratio``-th frame;
- each pathway: a stem (``conv1_kernel`` with stride (1, 2, 2) and half
  the kernel as padding, BatchNorm, ReLU, a 1x3x3 max pool of stride
  (1, 2, 2) and padding (0, 1, 1)), then four stages of 3-D bottlenecks
  (3, 4, 6, 3 for depth 50) of ``base_channels * 2**i`` planes: a 3x1x1
  first convolution where the stage is inflated (else 1x1x1), a 1x3x3
  second one with the spatial stride (2 in stages 2-4), a 1x1x1 third
  one to four times the planes, BatchNorm after each, ReLU after the
  first two and after the residual sum; a 1x1x1 convolution and
  BatchNorm on the shortcut where the shape changes;
- laterals (the paper's time-strided convolution, its third kind): a
  bare (5, 1, 1) convolution of temporal stride ``speed_ratio`` and
  padding (2, 0, 0) maps the fast stem's or stage's output of C /
  ``channel_ratio`` channels to 2 C / ``channel_ratio``, concatenated
  after the slow stem and after each slow stage but the last;
- head: each pathway's maps averaged over (T, H, W), [fast, slow]
  concatenated, dropout, one linear layer to the class scores; the
  loss is softmax cross-entropy averaged over the clips;
- BatchNorm in training mode with the configuration's stated semantics
  (``reference.resnet.BatchNorm``: flax's batch statistics
  ``E[x^2] - E[x]^2`` and running statistics ``0.9 old + 0.1 new`` of
  the biased variance; MMAction2 runs torch's, which keeps the unbiased
  variance and takes momentum 0.1 of the new: the one departure in the
  forward pass);
- dropout: flax's rule (zero with probability p, scale the rest by
  1 / (1 - p)) on the masks the caller draws (``dropout_keep``: the
  program's draws, as ``reference.device_aug`` takes the chain's);
- the update, in the program's chain order: the gradient clipped to
  global norm ``max_norm`` (``g / ||g|| * max_norm`` where
  ``||g|| >= max_norm``), the coupled weight decay added, momentum (the
  buffer starting at the first update), then ``-lr`` at mmcv's rate
  (``lr_at``).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .resnet import BatchNorm

# the program's stream of the heads' dropout draws ('drop')
DROPOUT_STREAM = 0x64726f70
STAGE_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}
FUSION_KERNEL = 5
EXPANSION = 4


def _half(kernel: Sequence[int]):
    return tuple(k // 2 for k in kernel)


class ConvBN(nn.Module):
    """Conv3d without bias, then BatchNorm (none for a lateral)."""

    def __init__(self, cin: int, cout: int, kernel, stride=(1, 1, 1),
                 padding=None, bn: bool = True):
        super().__init__()
        kernel = tuple(kernel)
        self.conv = nn.Conv3d(cin, cout, kernel, tuple(stride),
                              _half(kernel) if padding is None
                              else tuple(padding), bias=False)
        self.bn = BatchNorm(cout) if bn else None

    def forward(self, x):
        x = self.conv(x)
        return x if self.bn is None else self.bn(x)


class Bottleneck(nn.Module):

    def __init__(self, cin: int, planes: int, spatial_stride: int,
                 inflate: bool):
        super().__init__()
        self.conv1 = ConvBN(cin, planes, (3, 1, 1) if inflate else (1, 1, 1))
        self.conv2 = ConvBN(planes, planes, (1, 3, 3),
                            (1, spatial_stride, spatial_stride))
        self.conv3 = ConvBN(planes, planes * EXPANSION, (1, 1, 1))
        self.downsample = None
        if spatial_stride != 1 or cin != planes * EXPANSION:
            self.downsample = ConvBN(cin, planes * EXPANSION, (1, 1, 1),
                                     (1, spatial_stride, spatial_stride),
                                     (0, 0, 0))

    def forward(self, x):
        idt = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.conv1(x))
        out = F.relu(self.conv2(out))
        return F.relu(self.conv3(out) + idt)


class Pathway(nn.Module):
    """One pathway's stem and stages; the slow one holds the laterals
    (``lateral{i}``), whose output channels widen its stages' inputs."""

    def __init__(self, cfg: Dict, speed_ratio: int, channel_ratio: int):
        super().__init__()
        depth = cfg.get('depth', 50)
        base = cfg.get('base_channels', 64)
        inflate = tuple(cfg.get('inflate', (1, 1, 1, 1)))
        self.lateral = bool(cfg.get('lateral', False))
        self.conv1 = ConvBN(3, base, cfg['conv1_kernel'],
                            (cfg.get('conv1_stride_t', 1), 2, 2))
        self.pool_t = cfg.get('pool1_stride_t', 1)
        cin = base
        for i, n in enumerate(STAGE_BLOCKS[depth]):
            if self.lateral:
                # the slow stem's or stage's width over channel_ratio in,
                # twice that out
                fast = cin // channel_ratio
                self.add_module(f'lateral{i}', ConvBN(
                    fast, 2 * fast, (FUSION_KERNEL, 1, 1),
                    (speed_ratio, 1, 1), ((FUSION_KERNEL - 1) // 2, 0, 0),
                    bn=False))
                cin += 2 * fast
            planes = base * 2 ** i
            blocks = []
            for j in range(n):
                blocks.append(Bottleneck(cin, planes,
                                         (1 if i == 0 else 2) if j == 0
                                         else 1, bool(inflate[i])))
                cin = planes * EXPANSION
            self.add_module(f'layer{i + 1}', nn.Sequential(*blocks))
        self.stages = len(STAGE_BLOCKS[depth])
        self.out_channels = cin

    def stem(self, x):
        return F.max_pool3d(F.relu(self.conv1(x)), (1, 3, 3),
                            (self.pool_t, 2, 2), (0, 1, 1))


class Backbone(nn.Module):

    def __init__(self, cfg: Dict):
        super().__init__()
        self.resample_rate = cfg.get('resample_rate', 8)
        self.speed_ratio = cfg.get('speed_ratio', 8)
        ratio = cfg.get('channel_ratio', 8)
        self.slow_path = Pathway(cfg['slow_pathway'], self.speed_ratio, ratio)
        self.fast_path = Pathway(cfg['fast_pathway'], self.speed_ratio, ratio)

    def forward(self, x):
        slow, fast = self.slow_path, self.fast_path
        x_slow = slow.stem(x[:, :, ::self.resample_rate])
        x_fast = fast.stem(
            x[:, :, ::max(self.resample_rate // self.speed_ratio, 1)])
        for i in range(slow.stages):
            if slow.lateral:
                x_slow = torch.cat([x_slow, getattr(slow, f'lateral{i}')(
                    x_fast)], dim=1)
            x_slow = getattr(slow, f'layer{i + 1}')(x_slow)
            x_fast = getattr(fast, f'layer{i + 1}')(x_fast)
        return x_slow, x_fast


class Head(nn.Module):

    def __init__(self, in_channels: int, num_classes: int):
        super().__init__()
        self.fc_cls = nn.Linear(in_channels, num_classes)

    def forward(self, x_slow, x_fast, keep=None, p: float = 0.0):
        feat = torch.cat([x_fast.mean(dim=(2, 3, 4)),
                          x_slow.mean(dim=(2, 3, 4))], dim=1)
        if keep is not None:
            feat = torch.where(keep.bool(), feat / (1 - p),
                               torch.zeros_like(feat))
        return self.fc_cls(feat)


class SlowFast(nn.Module):
    """The recognizer of a configuration's ``model`` dict
    (``Recognizer3D`` over ``ResNet3dSlowFast`` and ``SlowFastHead``)."""

    def __init__(self, model_cfg: Dict):
        super().__init__()
        head = model_cfg['cls_head']
        self.backbone = Backbone(model_cfg['backbone'])
        self.cls_head = Head(head['in_channels'], head['num_classes'])
        self.dropout_ratio = head.get('dropout_ratio', 0.0)

    def forward(self, imgs, keep=None):
        """(N, clips, T, H, W, C) clips -> (N * clips, classes) scores;
        ``keep`` the dropout's mask (training) or None."""
        x = imgs.reshape(-1, *imgs.shape[2:]).permute(0, 4, 1, 2, 3)
        x_slow, x_fast = self.backbone(x)
        return self.cls_head(x_slow, x_fast, keep, self.dropout_ratio)


def cross_entropy(scores: torch.Tensor, labels: torch.Tensor):
    """Softmax cross-entropy averaged over the rows."""
    lsm = scores - torch.logsumexp(scores, dim=1, keepdim=True)
    return -lsm.gather(1, labels.long().view(-1, 1)).mean()


def dropout_keep(shape, p: float, generator: torch.Generator):
    """The dropout's keep mask of ``shape`` as the program draws it: one
    Bernoulli(1 - p) draw a value from ``generator``, on its device."""
    return torch.empty(shape, device=generator.device).bernoulli_(
        1 - p, generator=generator)


def lr_at(count: int, lr: float, lr_config: Dict, iters_per_epoch: int,
          total_epochs: int) -> float:
    """mmcv's ``CosineAnnealing`` rate by epoch with linear warm-up by
    epoch (``warmup_by_epoch``) at update ``count``: the epoch's cosine
    rate, times ``1 - (1 - count / W)(1 - warmup_ratio)`` over the first
    W = ``warmup_iters`` epochs of updates."""
    min_lr = lr_config.get('min_lr', 0.0)
    epoch = count // iters_per_epoch
    rate = min_lr + 0.5 * (lr - min_lr) * (
        1 + math.cos(math.pi * epoch / total_epochs))
    warm = lr_config.get('warmup_iters', 0) * iters_per_epoch
    if lr_config.get('warmup') == 'linear' and count < warm:
        ratio = lr_config.get('warmup_ratio', 0.1)
        rate *= 1 - (1 - count / warm) * (1 - ratio)
    return rate


def sgd_steps(model: SlowFast, batches: Sequence[torch.Tensor],
              labels: Sequence[torch.Tensor], keeps: Sequence,
              optimizer_cfg: Dict, max_norm: float,
              lr: Callable[[int], float]) -> Dict:
    """Train ``model`` one update a batch (module docstring); ``keeps``
    the dropout masks of each step, ``lr`` the rate of an update count.
    Returns each step's loss, each leaf's first gradient after the clip
    (the decay's input), each step's clipped gradient norm of each leaf
    and each step's global gradient norm before the clip: the caller
    reads the change from the model."""
    wd = optimizer_cfg.get('weight_decay', 0.0)
    mom = optimizer_cfg.get('momentum', 0.0)
    params = [(n, p) for n, p in model.named_parameters()]
    bufs: List = [None] * len(params)
    losses, first_grads, norms, totals = [], {}, [], []
    model.train()
    for count, (batch, label, keep) in enumerate(zip(batches, labels,
                                                     keeps)):
        for _, p in params:
            p.grad = None
        loss = cross_entropy(model(batch, keep), label)
        loss.backward()
        with torch.no_grad():
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for _, p in params]
            total = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            totals.append(float(total))
            if max_norm and bool(total >= max_norm):
                grads = [g / total * max_norm for g in grads]
            norms.append({name: float(torch.linalg.vector_norm(g))
                          for (name, _), g in zip(params, grads)})
            rate = lr(count)
            for k, ((name, p), g) in enumerate(zip(params, grads)):
                if count == 0:
                    first_grads[name] = g.clone()
                u = g + wd * p if wd else g
                if mom:
                    bufs[k] = u.clone() if bufs[k] is None \
                        else u + mom * bufs[k]
                    u = bufs[k]
                p.add_(-rate * u)
        losses.append(loss.detach())
    return dict(losses=losses, first_grads=first_grads, grad_norms=norms,
                total_norms=totals)
