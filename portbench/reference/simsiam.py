"""Plain SimSiam frame-level pretraining as VFS configures it (Xu & Wang,
ICCV 2021; Chen & He, CVPR 2021), the reference of the train cells.

- each of the two views of a (B, 2, T, H, W, C) batch runs through the
  ResNet on its own (its own BatchNorm batch of B*T frames);
- the head: global average pool, a projection MLP of Linear + BatchNorm
  (+ ReLU but after the last) and a predictor MLP of Linear + BatchNorm
  + ReLU then a last Linear; names as the program's state dict has them;
- the loss: ``2 - 2 cos(p, stopgrad(z))`` per frame, symmetric with
  weights 0.5; with ``intra_video`` the second view's (z, p) are rolled
  over the clip axis by 0..T-1 and each shift adds a term weighted 1/T;
  each term is averaged over the frames and the terms summed;
- SGD with coupled weight decay and momentum (the buffer starts at the
  first update), at the cosine schedule's rate of the update count.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .resnet import BatchNorm, ResNet


class MLPBlock(nn.Module):

    def __init__(self, cin: int, cout: int, bn: bool, relu: bool):
        super().__init__()
        self.fc = nn.Linear(cin, cout)
        self.bn = BatchNorm(cout) if bn else None
        self.relu = relu

    def forward(self, x):
        x = self.fc(x)
        if self.bn is not None:
            x = self.bn(x)
        return F.relu(x) if self.relu else x


class Head(nn.Module):

    def __init__(self, cin: int, proj_fcs: int, proj_mid: int, proj_out: int,
                 pred_fcs: int, pred_mid: int, pred_out: int):
        super().__init__()
        c = cin
        for i in range(proj_fcs):
            last = i == proj_fcs - 1
            out = proj_out if last else proj_mid
            self.add_module(f'projection_fc{i}', MLPBlock(c, out, True,
                                                          not last))
            c = out
        for i in range(pred_fcs):
            last = i == pred_fcs - 1
            out = pred_out if last else pred_mid
            self.add_module(f'predictor_fc{i}', MLPBlock(c, out, not last,
                                                         not last))
            c = out
        self.proj_fcs, self.pred_fcs = proj_fcs, pred_fcs

    def forward(self, x):
        z = x.mean(dim=(1, 2))
        for i in range(self.proj_fcs):
            z = getattr(self, f'projection_fc{i}')(z)
        p = z
        for i in range(self.pred_fcs):
            p = getattr(self, f'predictor_fc{i}')(p)
        return z, p


def normalize(x):
    return x / torch.clamp(torch.sqrt((x * x).sum(-1, keepdim=True)),
                           min=1e-12)


def cosine_loss(p, z):
    """``2 - 2 cos(p, z)`` per row."""
    return 2 - 2 * (normalize(p) * normalize(z)).sum(-1)


class SimSiam(nn.Module):
    """The model of a config's ``model`` dict (``SimSiamBaseTracker`` with
    a ``ResNet`` backbone and a ``SimSiamHead``)."""

    def __init__(self, model_cfg: Dict, intra_video: bool):
        super().__init__()
        bb, hd = model_cfg['backbone'], model_cfg['img_head']
        self.backbone = ResNet(bb['depth'], out_indices=bb['out_indices'])
        self.img_head = Head(
            hd['in_channels'], hd['num_projection_fcs'],
            hd['projection_mid_channels'], hd['projection_out_channels'],
            hd['num_predictor_fcs'], hd['predictor_mid_channels'],
            hd['predictor_out_channels'])
        self.intra_video = intra_video

    def forward(self, imgs):
        """(B, 2, T, H, W, C) -> the total loss."""
        b, _, t = imgs.shape[:3]
        frames = [imgs[:, v].reshape(b * t, *imgs.shape[3:])
                  for v in range(2)]
        z1, p1 = self.img_head(self.backbone(frames[0]))
        z2, p2 = self.img_head(self.backbone(frames[1]))
        weight = 1.0 / t if self.intra_video else 1.0
        shifts = range(t) if self.intra_video else range(1)
        total = 0.0
        for i in shifts:
            zr = torch.roll(z2.reshape(b, t, -1), i, 1).reshape(b * t, -1)
            pr = torch.roll(p2.reshape(b, t, -1), i, 1).reshape(b * t, -1)
            term = (cosine_loss(p1, zr.detach()) * 0.5
                    + cosine_loss(pr, z1.detach()) * 0.5) * weight
            total = total + term.mean()
        return total


def cosine_lr(base: float, count: int, total_iters: int) -> float:
    """Cosine annealing to 0 over ``total_iters`` updates (no warmup)."""
    count = min(count, total_iters)
    return base * 0.5 * (1 + math.cos(math.pi * count / total_iters))


def sgd_steps(model: SimSiam, batches: Sequence[torch.Tensor],
              optimizer_cfg: Dict, total_iters: int) -> Dict:
    """Train ``model`` one update a batch; returns each step's loss, each
    leaf's first gradient (the first update's input) and each step's
    gradient norm of each leaf: the caller reads the change from the
    model."""
    lr0 = optimizer_cfg['lr']
    wd = optimizer_cfg.get('weight_decay', 0.0)
    mom = optimizer_cfg.get('momentum', 0.0)
    params = [(n, p) for n, p in model.named_parameters()]
    bufs: List = [None] * len(params)
    losses, first_grads, norms = [], {}, []
    model.train()
    for count, batch in enumerate(batches):
        for _, p in params:
            p.grad = None
        loss = model(batch)
        loss.backward()
        lr = cosine_lr(lr0, count, total_iters)
        norms.append({name: float(torch.linalg.vector_norm(p.grad))
                      if p.grad is not None else 0.0
                      for name, p in params})
        with torch.no_grad():
            for k, (name, p) in enumerate(params):
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                if count == 0:
                    first_grads[name] = g.detach().clone()
                u = g + wd * p if wd else g
                if mom:
                    bufs[k] = u.clone() if bufs[k] is None \
                        else u + mom * bufs[k]
                    u = bufs[k]
                p.add_(-lr * u)
        losses.append(loss.detach())
    return dict(losses=losses, first_grads=first_grads, grad_norms=norms)
