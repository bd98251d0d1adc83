"""Optimizer and LR schedule builders (counterpart of
``vfs_tpu/core/optimizer/builder.py``).

The JAX package's optax chains are the contract, written out here over
torch parameters (``ChainedOptimizer``):

- SGD: ``add_decayed_weights`` (coupled decay) -> ``trace`` (momentum,
  the buffer starting at the first gradient) -> ``-lr``; torch's SGD
  computes the same update;
- Adam: ``scale_by_adam`` -> ``+ wd * p`` -> ``-lr``: the decay is added
  *after* the Adam scaling, which is AdamW's update, not
  ``torch.optim.Adam(weight_decay=...)`` (which adds it to the gradient);
- AdamW: the same chain with a default decay of 0.01 and eps 1e-8;
- ``grad_clip``: optax's ``clip_by_global_norm`` first in the chain,
  ``g / ||g|| * max_norm`` when ``||g|| >= max_norm``.

Schedules are functions of the update count (0 for the first update),
with optax's formulas for every policy: cosine, step, fixed, exp, tin and
linear warmup.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

import torch

Schedule = Callable[[int], float]


def _constant(value: float) -> Schedule:
    return lambda count: value


def _linear(init: float, end: float, steps: int) -> Schedule:
    """optax.linear_schedule."""
    def schedule(count):
        count = min(max(count, 0), steps)
        return (init - end) * (1 - count / steps) + end
    return schedule


def _tin(base_lr, min_lr, by_epoch, warmup, wu, warmup_ratio, total_iters,
         iters_per_epoch) -> Schedule:
    """The reference TINLrUpdaterHook (mmaction/core/lr/tin_lr_hook.py):
    cosine annealing whose progress is shifted by the warmup iterations,
    times the TIN ramp during warmup. The reference's mixed units under
    ``by_epoch`` (epoch progress minus iteration warmup) are kept, as in
    the JAX package."""
    max_epochs = total_iters / max(iters_per_epoch, 1)

    def schedule(count):
        i = float(count)
        if by_epoch:
            progress = math.floor(i / iters_per_epoch)
            max_progress = float(max_epochs)
        else:
            progress, max_progress = i, float(total_iters)
        if warmup is not None:
            progress -= wu
            max_progress -= wu
        factor = progress / max_progress
        reg = min_lr + 0.5 * (base_lr - min_lr) * (
            math.cos(math.pi * factor) + 1.0)
        if warmup == 'linear':
            k = (i / wu) * (1 - warmup_ratio) + warmup_ratio
        elif warmup == 'constant':
            k = warmup_ratio
        elif warmup == 'exp':
            k = warmup_ratio ** (1 - i / wu)
        else:
            return reg
        return reg * k if i < wu else reg
    return schedule


def build_lr_schedule(lr_config: Optional[Dict], base_lr: float,
                      total_iters: int, iters_per_epoch: int = 1
                      ) -> Schedule:
    """An mmcv ``lr_config`` -> the learning rate as a function of the
    update count."""
    if lr_config is None:
        return _constant(base_lr)
    cfg = dict(lr_config)
    policy = cfg.pop('policy', 'fixed').lower()
    by_epoch = cfg.pop('by_epoch', True)
    warmup = cfg.pop('warmup', None)
    warmup_iters = cfg.pop('warmup_iters', 0)
    warmup_ratio = cfg.pop('warmup_ratio', 0.1)
    raw_warmup_iters = warmup_iters  # mmcv semantics: always iterations
    if by_epoch and warmup_iters:
        warmup_iters *= iters_per_epoch

    if policy == 'tin':
        return _tin(base_lr, cfg.pop('min_lr', 0.0), by_epoch, warmup,
                    raw_warmup_iters, warmup_ratio, total_iters,
                    iters_per_epoch)
    if policy in ('cosineannealing', 'cosine'):
        min_lr = cfg.pop('min_lr', 0.0)
        alpha = min_lr / base_lr if base_lr else 0.0
        decay_steps = max(total_iters - warmup_iters, 1)

        def sched(count):  # optax.cosine_decay_schedule
            count = min(count, decay_steps)
            cosine = 0.5 * (1 + math.cos(math.pi * count / decay_steps))
            return base_lr * ((1 - alpha) * cosine + alpha)
    elif policy == 'step':
        steps = cfg.pop('step')
        gamma = cfg.pop('gamma', 0.1)
        if not isinstance(steps, (list, tuple)):
            steps = [steps]
        thresholds = sorted({int(s * iters_per_epoch if by_epoch else s)
                             for s in steps})

        def sched(count):  # optax.piecewise_constant_schedule
            value = base_lr
            for t in thresholds:
                if count >= t:
                    value *= gamma
            return value
    elif policy == 'fixed':
        sched = _constant(base_lr)
    elif policy in ('exp', 'exponential'):
        gamma = cfg.pop('gamma')
        transition = iters_per_epoch if by_epoch else 1

        def sched(count):  # optax.exponential_decay
            if count <= 0:
                return base_lr
            return base_lr * gamma ** (count / transition)
    else:
        raise KeyError(f'unknown lr policy {policy}')

    if warmup is not None and warmup_iters > 0:
        if warmup != 'linear':
            raise ValueError(f'warmup={warmup!r}: only linear warmup is '
                             'supported outside the tin policy')
        warm = _linear(base_lr * warmup_ratio, base_lr, warmup_iters)
        main = sched

        def sched(count):  # optax.join_schedules
            return warm(count) if count < warmup_iters \
                else main(count - warmup_iters)
    return sched


class ChainedOptimizer:
    """The optax chain of ``build_optimizer`` over the parameters that
    require a gradient (a missing gradient counts as zero, as ``jax.grad``
    gives). ``step`` applies one update at ``schedule(count)`` and advances
    ``count``; ``state_dict`` / ``load_state_dict`` carry the count and the
    moments. ``mults``, one (lr, weight decay) multiplier pair a parameter,
    gives each parameter the chain of its group (``optax.multi_transform``
    over chains that differ in those two numbers, as the TSM optimizer's
    groups do)."""

    def __init__(self, params: Iterable[torch.Tensor], kind: str,
                 schedule: Schedule, weight_decay: float = 0.0,
                 momentum: float = 0.0, nesterov: bool = False,
                 betas: Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8, grad_clip: Optional[float] = None,
                 mults: Optional[Sequence[Tuple[float, float]]] = None):
        if kind not in ('SGD', 'Adam', 'AdamW'):
            raise KeyError(f'unknown optimizer {kind}')
        params = list(params)
        mults = [(1.0, 1.0)] * len(params) if mults is None else list(mults)
        if len(mults) != len(params):
            raise ValueError('one (lr, weight decay) pair a parameter')
        self.params = [p for p in params if p.requires_grad]
        self.mults = [m for p, m in zip(params, mults) if p.requires_grad]
        self.kind = kind
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.momentum = momentum
        self.nesterov = nesterov
        self.betas = betas
        self.eps = eps
        self.grad_clip = grad_clip
        self.count = 0
        self.moments = [[] for _ in self.params]

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    def _grads(self):
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        if self.grad_clip:
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            if not bool(norm < self.grad_clip):
                grads = [g / norm * self.grad_clip for g in grads]
        return grads

    @torch.no_grad()
    def step(self) -> float:
        """One update; returns the learning rate it used."""
        base_lr = float(self.schedule(self.count))
        for p, g, moments, (lr_mult, wd_mult) in zip(
                self.params, self._grads(), self.moments, self.mults):
            lr, wd = base_lr * lr_mult, self.weight_decay * wd_mult
            if self.kind == 'SGD':
                u = g + wd * p if wd else g
                if self.momentum:
                    if not moments:
                        moments.append(torch.zeros_like(p))
                    buf = moments[0]
                    buf.copy_(u + self.momentum * buf)
                    u = u + self.momentum * buf if self.nesterov \
                        else buf
            else:
                b1, b2 = self.betas
                if not moments:
                    moments += [torch.zeros_like(p), torch.zeros_like(p)]
                mu, nu = moments
                mu.copy_((1 - b1) * g + b1 * mu)
                nu.copy_((1 - b2) * (g * g) + b2 * nu)
                n = self.count + 1
                u = (mu / (1 - b1 ** n)) / (
                    torch.sqrt(nu / (1 - b2 ** n)) + self.eps)
                if wd:
                    u = u + wd * p
            p.add_(-lr * u)
        self.count += 1
        return base_lr

    def state_dict(self) -> Dict:
        return dict(count=self.count, moments=self.moments)

    def load_state_dict(self, state: Dict):
        if len(state['moments']) != len(self.params):
            raise ValueError('optimizer state for another parameter list')
        self.count = int(state['count'])
        self.moments = [[m.to(p.device) for m in ms]
                        for ms, p in zip(state['moments'], self.params)]


def build_optimizer(params: Iterable[torch.Tensor], optimizer_cfg: Dict,
                    lr_config: Optional[Dict] = None, total_iters: int = 1,
                    iters_per_epoch: int = 1,
                    grad_clip: Optional[float] = None
                    ) -> Tuple[ChainedOptimizer, Schedule]:
    """cfg -> (optimizer over ``params``, schedule)."""
    cfg = dict(optimizer_cfg)
    kind = cfg.pop('type')
    base_lr = cfg.pop('lr')
    schedule = build_lr_schedule(lr_config, base_lr, total_iters,
                                 iters_per_epoch)
    if kind == 'SGD':
        kwargs = dict(weight_decay=cfg.pop('weight_decay', 0.0),
                      momentum=cfg.pop('momentum', 0.0),
                      nesterov=cfg.pop('nesterov', False))
    elif kind == 'Adam':
        kwargs = dict(weight_decay=cfg.pop('weight_decay', 0.0),
                      betas=tuple(cfg.pop('betas', (0.9, 0.999))),
                      eps=cfg.pop('eps', 1e-8))
    elif kind == 'AdamW':
        # the JAX chain passes no eps here: optax's default 1e-8
        kwargs = dict(weight_decay=cfg.pop('weight_decay', 0.01),
                      betas=tuple(cfg.pop('betas', (0.9, 0.999))))
    else:
        raise KeyError(f'unknown optimizer {kind}')
    return ChainedOptimizer(params, kind, schedule, grad_clip=grad_clip,
                            **kwargs), schedule
