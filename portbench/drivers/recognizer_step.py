"""Recognizer training steps as ``apis.train.train_model`` drives them:
the step that ``make_train_step`` returns, called as ``step(imgs,
labels=...)``, over a model built from the configuration's ``model``
dict (``build_model``, channels-last backbone, train mode) and the
optimizer of its ``optimizer``, ``lr_config`` and
``optimizer_config.grad_clip`` (``build_optimizer``), fed clips and
labels that are already on the card, as a loader that keeps up would
hand them over. The head's dropout draws from the step's own generator.

Set-up makes the seeded weights (``seeded_state``: the program's own
``init_weights``, BatchNorm perturbed) and the traffic's ring of batches
with labels on the card, and drives the step through its first
``CHECKED_STEPS`` updates on ring batches 0, 1, 2, reading each step's
loss, the first gradient after the clip (the optimizer's momentum after
one update, less the weight decay) and the change of every leaf after
the third. The window then runs the same step object on the ring, with
no synchronisation between steps, until the host clock passes
``--seconds``, and ends in a ``torch.cuda.synchronize()``:
``train_samples_per_s`` is the clips of every step over all that time.
A traced run also records a CUDA event at each step boundary of the
window (``train_step_ms_p95``, ``train_mfu``) and then profiles
``trace_steps`` more steps inside the benchmark's span ``step``, with
the program's spans and counters recorded over them
(``harness.program_window``; ``counts['program']``).

``correct``: once the program is freed, the plain reference
(``reference.slowfast``, fp32, TF32 off) runs the same three updates
from the same weights on the same batches and labels, with the program's
dropout masks (drawn as the program draws them). Compared (``compare``):
``first_loss_gap``, the relative gap of the first step's loss, and by
``train_step``'s rules ``grad_gap_p90``, ``grad_gap_max`` and
``change_gap``. The later steps' losses are not compared: two correct
fp32 computations of this model already part by up to ~4e-3 there, as
much as the TF32 control (the first update's rounding, carried by the
fast pathway's early BatchNorms; the configuration's ``limits_why``).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import torch

from portbench.drivers import train_step
from portbench.drivers.train_step import (CHECKED_STEPS, RANK, leaf_norms,
                                          program_steps, total_iters,
                                          worst_leaves)
from portbench.harness import conv_work, traffic as traffic_gen
from portbench.harness.program_window import program_window
from portbench.harness.runner import Check, Outcome
from portbench.harness.trace import spanned
from portbench.reference import precision, slowfast
from portbench.reference.device_aug import step_seed


def max_norm(cfg: Dict) -> Optional[float]:
    clip = (cfg.get('optimizer_config') or {}).get('grad_clip')
    return clip['max_norm'] if clip else None


def clips_of(tr: Dict) -> int:
    return tr['batch'] * tr['views']


def seeded_state(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The configuration's ``weights`` rule ``program_init_bn_perturbed``:
    the program's ``init_weights`` from a generator on ``device`` seeded
    by ``seed``, then every BatchNorm scale 1 + 0.1 N(0, 1) and shift
    0.1 N(0, 1) from the same generator; running statistics 0 and 1."""
    from vfs_tpu_torch.models import build_model
    if cfg['weights'] != 'program_init_bn_perturbed':
        raise KeyError(f"unknown weight rule {cfg['weights']!r}")
    with torch.device('meta'):
        model = build_model(dict(cfg['model']))
    model = model.to_empty(device=device)
    generator = torch.Generator(device=device)
    generator.manual_seed(int(seed))
    with torch.no_grad():
        model.init_weights(generator)
        for m in model.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                m.weight.copy_(1.0 + 0.1 * torch.randn(
                    m.weight.shape, generator=generator, device=device))
                m.bias.copy_(0.1 * torch.randn(
                    m.bias.shape, generator=generator, device=device))
    return {k: v.detach() for k, v in model.state_dict().items()}


def batch(cfg: Dict, tr: Dict, seed: int, index: int,
          device) -> Dict[str, torch.Tensor]:
    """Ring batch ``index``: the generator's clips and labels uniform over
    the head's classes, from the seed."""
    rng = traffic_gen.seed_rng(seed, 2, index)
    labels = rng.integers(0, cfg['model']['cls_head']['num_classes'],
                          clips_of(tr))
    return dict(imgs=traffic_gen.train_batch(tr, seed, index, device,
                                              cfg['img_norm_cfg'])['imgs'],
                labels=torch.as_tensor(labels, device=device))


def build_program(cfg: Dict, state: Dict[str, torch.Tensor], dev):
    """The model and optimizer that ``train_model`` builds, holding
    ``state``."""
    from vfs_tpu_torch.core.optimizer import build_optimizer
    from vfs_tpu_torch.device import to_channels_last
    from vfs_tpu_torch.models import build_model

    with torch.device('meta'):
        model = build_model(dict(cfg['model']))
    model = model.to_empty(device=dev)
    model.load_state_dict(state)
    if torch.device(dev).type == 'cuda':
        to_channels_last(model.backbone)
    model.train()
    s = cfg['schedule']
    optimizer, _ = build_optimizer(model.parameters(), cfg['optimizer'],
                                   cfg['lr_config'], total_iters(cfg),
                                   s['iters_per_epoch'], max_norm(cfg))
    return model, optimizer


def reference_steps(cfg: Dict, tr: Dict, seed: int, device,
                    state: Dict[str, torch.Tensor], mode: str = 'fp32',
                    memory_format=torch.contiguous_format) -> Dict:
    """The reference's three updates from ``state`` on ring batches 0..,
    with the program's dropout masks; ``memory_format`` that of its
    weights (another layout, other convolution kernels)."""
    with torch.device('meta'):
        model = slowfast.SlowFast(cfg['model'])
    model = model.to_empty(device=device)
    model.load_state_dict(state)
    model.to(memory_format=memory_format)
    start = {k: v.detach().clone() for k, v in model.state_dict().items()
             if v.is_floating_point()}
    batches = [batch(cfg, tr, seed, i, device) for i in range(CHECKED_STEPS)]
    p = model.dropout_ratio
    keeps = []
    for count in range(CHECKED_STEPS):
        g = torch.Generator(device=device)
        g.manual_seed(step_seed(seed, RANK, count, slowfast.DROPOUT_STREAM))
        keeps.append(slowfast.dropout_keep(
            (clips_of(tr), model.cls_head.fc_cls.in_features), p, g)
            if p else None)
    s = cfg['schedule']

    def lr(count: int) -> float:
        return slowfast.lr_at(count, cfg['optimizer']['lr'],
                              cfg['lr_config'], s['iters_per_epoch'],
                              s['total_epochs'])
    with precision.matmul_precision(mode):
        out = slowfast.sgd_steps(model, [b['imgs'] for b in batches],
                                 [b['labels'] for b in batches], keeps,
                                 cfg['optimizer'], max_norm(cfg), lr)
    now = model.state_dict()
    change = leaf_norms({k: now[k] - v for k, v in start.items()})
    return dict(losses=[float(x) for x in out['losses']],
                grads=leaf_norms(out['first_grads']), change=change,
                step_grads=out['grad_norms'], total_norms=out['total_norms'])


def compare(program: Dict, ref: Dict, limits: Dict) -> List[Check]:
    """``first_loss_gap`` and ``train_step.compare``'s checks but its
    ``loss_gap`` over every step (module docstring)."""
    first = abs(program['losses'][0] - ref['losses'][0]) \
        / abs(ref['losses'][0])
    rest = train_step.compare(program, ref,
                              dict(limits, loss_gap=float('inf')))
    return [Check('first_loss_gap', first, limits['first_loss_gap'])] + [
        c for c in rest if c.name != 'loss_gap']


def step_work(cfg: Dict, tr: Dict) -> Dict:
    """The frozen counts of one step (``conv_work.slowfast_work``)."""
    with torch.device('meta'):
        model = slowfast.SlowFast(cfg['model'])
    return conv_work.slowfast_work(
        model, (tr['frames'], tr['height'], tr['width'], 3), clips_of(tr))


def run(ctx) -> Outcome:
    from vfs_tpu_torch.apis.train import make_train_step

    cfg, tr, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    cuda = torch.device(dev).type == 'cuda'
    parts = dict(imports=time.perf_counter() - ctx.t_start)
    state = seeded_state(cfg, ctx.seed, dev)
    model, optimizer = build_program(cfg, state, dev)
    parts['model'] = time.perf_counter() - ctx.t_start
    step = make_train_step(model, optimizer, seed=ctx.seed)
    ring = [batch(cfg, tr, ctx.seed, i, dev) for i in range(tr['ring'])]
    if cuda:
        torch.cuda.synchronize()
    parts['inputs'] = time.perf_counter() - ctx.t_start
    if ctx.tamper is not None:
        step = ctx.tamper(step, model, optimizer)
    wd = cfg['optimizer'].get('weight_decay', 0.0)
    mine = program_steps(step, optimizer, model, ring, wd)
    if ctx.trace:
        step = spanned('step', step)
    if cuda:
        torch.cuda.synchronize()

    losses, events = [], []
    n = len(ring)
    steps = 0
    t0 = time.perf_counter()
    setup_s = t0 - ctx.t_start
    while True:
        losses.append(step(**ring[steps % n])['loss'])
        steps += 1
        if ctx.trace and cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            events.append(e)
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    if cuda:
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    counts: Dict = {}
    recorded: Dict = {}
    if ctx.trace:
        counts['step_ms'] = [a.elapsed_time(b) for a, b in
                             zip(events, events[1:])]
        counts['event_steps'] = len(events) - 1
        counts['event_s'] = sum(counts['step_ms']) / 1e3
        traced_steps = tr['trace_steps']
        with program_window(dev, recorded):
            for i in range(traced_steps):
                losses.append(step(**ring[(steps + i) % n])['loss'])
        counts['traced_steps'] = traced_steps
        counts['program'] = recorded['program']
        work = step_work(cfg, tr)
        counts['step_flops'] = work['step_flops']
        counts['slowfast_work'] = work
    failed = sum(1 for x in losses if not bool(torch.isfinite(x)))
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    del model, optimizer, step, ring, losses
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    ref = reference_steps(cfg, tr, ctx.seed, dev, state)
    checks = compare(mine, ref, cfg['limits'])
    check_s = time.perf_counter() - t_check
    return Outcome(setup_s, dict(train_samples_per_s=clips_of(tr) * steps
                                 / window_s),
                   steps, failed, peak, checks, counts,
                   recorded.get('trace'),
                   dict(window={'seconds': window_s, 'steps': steps,
                                'check_s': check_s},
                        setup_parts=parts))


def half_batch(step, model, optimizer):
    """A fault: the step fed the first half of each batch."""
    def half(imgs, orig_hw=None, labels=None):
        n = imgs.shape[0] // 2
        return step(imgs[:n], orig_hw, labels[:n])
    return half


def no_laterals(step, model, optimizer):
    """A fault: the laterals give zeros, so the slow pathway never sees
    the fast one."""
    slow = model.backbone.slow_path
    for i in range(slow.num_stages):
        lateral = getattr(slow, f'lateral{i}')
        lateral.forward = (lambda x, conv=lateral.conv:
                           torch.zeros_like(conv(x)))
    return step


FAULTS: Dict[str, Callable] = dict(half_batch=half_batch,
                                   no_laterals=no_laterals)


def readings(cell, seed: int, device, what: str):
    """The compared numbers of one seed without a window, and the detail:
    the leaves with the largest gaps, each step's loss on both sides and
    the reference's global gradient norm before the clip at each step:
    ``'program'`` (the program's first updates,
    as a run's set-up drives them), ``'control'`` (the reference in TF32
    in the program's place), ``'reference_ndhwc'`` (the reference with
    channels-last weights: another correct fp32 computation) or a fault
    of ``FAULTS``."""
    from vfs_tpu_torch.apis.train import make_train_step

    cfg, tr = cell.config, cell.traffic
    state = seeded_state(cfg, seed, device)
    if what == 'control':
        other = reference_steps(cfg, tr, seed, device, state, mode='tf32')
    elif what == 'reference_ndhwc':
        other = reference_steps(cfg, tr, seed, device, state,
                                memory_format=torch.channels_last_3d)
    elif what == 'program' or what in FAULTS:
        model, optimizer = build_program(cfg, state, device)
        step = make_train_step(model, optimizer, seed=seed)
        if what in FAULTS:
            step = FAULTS[what](step, model, optimizer)
        ring = [batch(cfg, tr, seed, i, device) for i in range(CHECKED_STEPS)]
        other = program_steps(step, optimizer, model, ring,
                              cfg['optimizer'].get('weight_decay', 0.0))
        del model, optimizer, step, ring
        if torch.device(device).type == 'cuda':
            torch.cuda.empty_cache()
    else:
        raise KeyError(what)
    ref = reference_steps(cfg, tr, seed, device, state)
    detail = dict(worst_leaves(other, ref), losses=other['losses'],
                  ref_losses=ref['losses'], total_norms=ref['total_norms'])
    return compare(other, ref, cfg['limits']), detail
