"""SimSiam pretraining steps as ``apis.train.train_model`` drives them:
the step that ``make_train_step`` returns, over a model built from the
configuration's ``model`` dict (``build_model``, channels-last backbone,
train mode) and the optimizer of its ``optimizer`` and ``lr_config``
(``build_optimizer``), fed batches that are already on the card, as a
loader that keeps up would hand them over. With uint8 staging traffic the
step runs the configuration's ``device_aug`` chain (``build_device_aug``).

Set-up makes the seeded weights and the traffic's ring of batches on the
card and drives the step through its first ``CHECKED_STEPS`` updates on
ring batches 0, 1, 2, reading each step's loss, the first gradient (the
optimizer's momentum after one update, less the weight decay) and the
change of every leaf after the third. The window then runs the same step
object on the ring, with no synchronisation between steps, until the host
clock passes ``--seconds``, and ends in a ``torch.cuda.synchronize()``:
``train_samples_per_s`` is the samples of every step over all that time.
A traced run also records a CUDA event at each step boundary of the
window (``train_step_ms_p95``, ``train_mfu``) and then profiles
``trace_steps`` more steps, with spans around the step and the
augmentation chain.

``correct``: once the program is freed, the plain reference
(``reference.simsiam``, fp32, TF32 off; for staging traffic after the
chain written plainly from its transforms' definitions,
``reference.device_aug``, on the program's draws) runs the same three
updates from the same weights on the same batches. Compared:
``loss_gap``, the largest relative gap of a step's loss; of the gap
between the program's and the reference's norm of a leaf, over the
larger of that leaf's reference norm and the median leaf's: of the
first gradient, ``grad_gap_p90``, the 90th percentile over the leaves,
and ``grad_gap_max``, the largest (it falls on a BatchNorm scale or
shift, a sum over every position that one ReLU decision at the kink
moves, so it swings from seed to seed; the percentile is the steady
reading), and ``change_gap``, the largest over the leaves of the
change's gap after three updates. Left out by a rule on the reference's
gradient (``leaves``): of the first gradient, the leaves whose norm is
under a thousandth of the median leaf's; of the change, those under it
at every step. The BatchNorm running statistics count as leaves of the
change.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from portbench.harness import flops, traffic as traffic_gen, weights
from portbench.harness.runner import Check, Outcome
from portbench.harness.trace import spanned, traced
from portbench.reference import device_aug as ref_aug
from portbench.reference import precision, simsiam

CHECKED_STEPS = 3
# the seed of the augmentation draws is that of rank 0 in one process
RANK = 0


def total_iters(cfg: Dict) -> int:
    s = cfg['schedule']
    return s['total_epochs'] * s['iters_per_epoch']


def reference_model(cfg: Dict, device) -> simsiam.SimSiam:
    return simsiam.SimSiam(cfg['model'],
                           cfg['train_cfg']['intra_video']).to(device)


def staging(traffic: Dict) -> bool:
    return traffic['dtype'] == 'uint8'


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in tensors.items()}


def leaf_gaps(program: Dict[str, float], ref: Dict[str, float],
              keep) -> Dict[str, float]:
    """Each leaf's gap of its norm, over the larger of the leaf's reference
    norm and the median leaf's."""
    med = float(np.median([ref[k] for k in keep]))
    return {k: abs(program[k] - ref[k]) / max(ref[k], med) for k in keep}


def program_steps(step, optimizer, model, ring, wd: float) -> Dict:
    """Drive the program's step through ``CHECKED_STEPS`` updates on ring
    batches 0.. and read its numbers."""
    params = dict(model.named_parameters())
    start = {k: v.detach().clone() for k, v in model.state_dict().items()
             if v.is_floating_point()}
    losses, first = [], None
    for i in range(CHECKED_STEPS):
        losses.append(step(**ring[i])['loss'])
        if i == 0:
            # the optimizer's state after one update: momentum = g + wd p
            # (none where the update did not run)
            by_param = {id(p): m[0] if m else torch.zeros_like(p)
                        for p, m in zip(optimizer.params,
                                        optimizer.moments)}
            first = leaf_norms({k: by_param[id(p)] - wd * start[k]
                                for k, p in params.items()})
    now = model.state_dict()
    change = leaf_norms({k: now[k] - v for k, v in start.items()})
    return dict(losses=[float(x) for x in losses], grads=first,
                change=change)


def reference_steps(cfg: Dict, tr: Dict, seed: int, device,
                    mode: str = 'fp32', batches=None) -> Dict:
    """The reference's three updates from the seeded weights on ring
    batches 0..; ``batches`` replaces the ring's (a fault)."""
    model = reference_model(cfg, 'meta')
    state = weights.seeded_state(model, cfg['weights'], seed, device)
    model = reference_model(cfg, device)
    model.load_state_dict(state)
    start = {k: v.detach().clone() for k, v in state.items()
             if v.is_floating_point()}
    del state
    if batches is None:
        batches = [traffic_gen.train_batch(tr, seed, i, device,
                                           cfg['img_norm_cfg'])
                   for i in range(CHECKED_STEPS)]
    with precision.matmul_precision(mode):
        if staging(tr):
            da = cfg['device_aug']
            chain = ref_aug.build_device_aug(
                da['transforms'], cfg['img_norm_cfg'],
                tuple(da['out_hw']), precision=mode)
            inputs = []
            for count, b in enumerate(batches):
                g = torch.Generator(device=device)
                g.manual_seed(ref_aug.step_seed(seed, RANK, count))
                inputs.append(chain(b['imgs'], b['orig_hw'], g))
        else:
            inputs = [b['imgs'] for b in batches]
        out = simsiam.sgd_steps(model, inputs, cfg['optimizer'],
                                total_iters(cfg))
    now = model.state_dict()
    change = leaf_norms({k: now[k] - v for k, v in start.items()})
    return dict(losses=[float(x) for x in out['losses']],
                grads=leaf_norms(out['first_grads']), change=change,
                step_grads=out['grad_norms'])


def nought(grads: Dict[str, float]) -> set:
    """Leaves whose gradient norm is under 1e-3 of the median leaf's."""
    med = float(np.median(list(grads.values())))
    return {k for k, v in grads.items() if v < 1e-3 * med}


def leaves(ref: Dict):
    """The leaves compared: those of the first gradient, without the ones
    nought in the reference's first step (the residual branches behind a
    zero-initialised BatchNorm scale get none yet), and those of the
    change, without the ones nought in every one of its steps (the
    Linear biases before a BatchNorm, which SGD's decay and round-off
    alone move)."""
    kept = [k for k in ref['grads'] if k not in nought(ref['grads'])]
    always = set.intersection(*(nought(g) for g in ref['step_grads']))
    return kept, [k for k in ref['change'] if k not in always]


def compare(program: Dict, ref: Dict, limits: Dict) -> List[Check]:
    kept, changed = leaves(ref)
    loss = max(abs(a - b) / abs(b) for a, b in zip(program['losses'],
                                                   ref['losses']))
    grads = list(leaf_gaps(program['grads'], ref['grads'], kept).values())
    change = leaf_gaps(program['change'], ref['change'], changed)
    return [Check('loss_gap', loss, limits['loss_gap']),
            Check('grad_gap_p90', float(np.percentile(grads, 90)),
                  limits['grad_gap_p90']),
            Check('grad_gap_max', max(grads), limits['grad_gap_max']),
            Check('change_gap', max(change.values()), limits['change_gap'])]


def worst_leaves(program: Dict, ref: Dict, n: int = 3) -> Dict:
    """The ``n`` leaves with the largest gaps of each compared norm (name,
    gap, norm over the median leaf's), and the gaps' median, 90th
    percentile and largest over the leaves."""
    out = {}
    for key, keep in zip(('grads', 'change'), leaves(ref)):
        med = float(np.median([ref[key][k] for k in keep]))
        gaps = leaf_gaps(program[key], ref[key], keep)
        worst = sorted(gaps, key=gaps.get, reverse=True)[:n]
        out[key] = [[k, gaps[k], ref[key][k] / med] for k in worst]
        values = list(gaps.values())
        out[key + '_median'] = float(np.median(values))
        out[key + '_p90'] = float(np.percentile(values, 90))
        out[key + '_max'] = float(max(values))
    return out


def build_program(cfg: Dict, tr: Dict, seed: int, dev):
    """The model, optimizer, chain and step that ``train_model`` builds,
    with the seeded weights."""
    from vfs_tpu_torch.core.optimizer import build_optimizer
    from vfs_tpu_torch.device import to_channels_last
    from vfs_tpu_torch.models import build_model
    from vfs_tpu_torch.ops.device_aug import build_device_aug

    model = build_model(dict(cfg['model']), train_cfg=dict(cfg['train_cfg']))
    model.load_state_dict(weights.seeded_state(
        reference_model(cfg, 'meta'), cfg['weights'], seed, dev))
    model.to(dev)
    if torch.device(dev).type == 'cuda':
        to_channels_last(model.backbone)
    model.train()
    s = cfg['schedule']
    optimizer, _ = build_optimizer(model.parameters(), cfg['optimizer'],
                                   cfg['lr_config'], total_iters(cfg),
                                   s['iters_per_epoch'])
    chain = None
    if staging(tr):
        da = cfg['device_aug']
        chain = build_device_aug(da['transforms'], cfg['img_norm_cfg'],
                                 tuple(da['out_hw']))
    return model, optimizer, chain


def run(ctx) -> Outcome:
    from vfs_tpu_torch.apis.train import make_train_step

    cfg, tr, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    cuda = torch.device(dev).type == 'cuda'
    parts = dict(imports=time.perf_counter() - ctx.t_start)
    model, optimizer, chain = build_program(cfg, tr, ctx.seed, dev)
    parts['model'] = time.perf_counter() - ctx.t_start
    if ctx.trace and chain is not None:
        chain = spanned('device_aug', chain)
    step = make_train_step(model, optimizer, device_aug=chain, seed=ctx.seed)
    ring = traffic_gen.train_ring(tr, ctx.seed, dev, cfg['img_norm_cfg'])
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
    batch = tr['batch']
    counts: Dict = {}
    recorded: Dict = {}
    if ctx.trace:
        counts['step_ms'] = [a.elapsed_time(b) for a, b in
                             zip(events, events[1:])]
        counts['event_steps'] = len(events) - 1
        counts['event_s'] = sum(counts['step_ms']) / 1e3
        traced_steps = tr['trace_steps']
        with traced(dev, recorded):
            for i in range(traced_steps):
                losses.append(step(**ring[(steps + i) % n])['loss'])
        counts['traced_steps'] = traced_steps
        counts['step_flops'] = flops.train_flops(
            reference_model(cfg, 'meta'), tuple(cfg['device_aug']['out_hw'])
            if staging(tr) else (tr['height'], tr['width']),
            batch * tr['views'] * tr['frames'])
    failed = sum(1 for x in losses if not bool(torch.isfinite(x)))
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    del model, optimizer, step, ring, losses, chain
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    ref = reference_steps(cfg, tr, ctx.seed, dev)
    checks = compare(mine, ref, cfg['limits'])
    check_s = time.perf_counter() - t_check
    return Outcome(setup_s, dict(train_samples_per_s=batch * steps
                                 / window_s),
                   steps, failed, peak, checks, counts,
                   recorded.get('trace'),
                   dict(window={'seconds': window_s, 'steps': steps,
                                'check_s': check_s},
                        setup_parts=parts))


def readings(cell, seed: int, device, what: str):
    """The compared numbers of one seed without a window, and the leaves
    with the largest gaps: ``'program'``
    (the program's first updates, as a run's set-up drives them),
    ``'control'`` (the reference in TF32 in the program's place) or
    ``'half_batch'`` (the program fed the first half of each batch, its
    loss the mean over that half)."""
    from vfs_tpu_torch.apis.train import make_train_step

    cfg, tr = cell.config, cell.traffic
    ref = reference_steps(cfg, tr, seed, device)
    if what == 'control':
        other = reference_steps(cfg, tr, seed, device, mode='tf32')
    elif what in ('program', 'half_batch'):
        model, optimizer, chain = build_program(cfg, tr, seed, device)
        step = make_train_step(model, optimizer, device_aug=chain,
                               seed=seed)
        ring = [traffic_gen.train_batch(tr, seed, i, device,
                                        cfg['img_norm_cfg'])
                for i in range(CHECKED_STEPS)]
        if what == 'half_batch':
            half = tr['batch'] // 2
            ring = [{k: v[:half] for k, v in b.items()} for b in ring]
        other = program_steps(step, optimizer, model, ring,
                              cfg['optimizer'].get('weight_decay', 0.0))
    else:
        raise KeyError(what)
    return compare(other, ref, cfg['limits']), worst_leaves(other, ref)
