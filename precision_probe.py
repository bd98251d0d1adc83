#!/usr/bin/env python3
"""Locate where an exact-fp32 train step leaves the fp64 one, op by op, on
one CUDA card and on the CPU.

    python3 precision_probe.py [--scan N] [--out FILE.json]

On the first two samples of the r18 config's first mp4v batch (the batch
``chip_smoke.card_vs_cpu_kinks`` takes: ``chip_smoke.write_k400``'s clips,
``chip_smoke.loader_first_batch``) it runs one train step of the seeded
model in fp64 on the CPU (the exact answer), in fp32 on the CPU and in
fp32 on the card, recording every module's output and every ``F.relu``
input of the backbone and their gradients. It prints one JSON line a
run: the largest per-parameter gradient error (``chip_smoke.grad_error``),
the ReLU decisions that differ from fp64's (count, the largest distance
from 0 in fp32 ulps of the call's RMS input) and the first tensor, in
backward order, whose gradient error jumps past 100x the one after it,
with that position's values. Then the card's fp32 step under variants
that would remove a less accurate op: cuDNN off, cuDNN deterministic, a
contiguous (not channels_last) backbone, BatchNorm statistics summed in
fp64, the whole BatchNorm in fp64 (also on the CPU). ``--scan N`` adds
the gradient errors of card and CPU for the first N two-sample slices of
the batch. ``--out`` writes every tensor's errors as JSON. Needs one
card; prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.abspath(__file__))


def rel(a, b):
    nb = float(b.norm())
    return float((a - b).norm()) / nb if nb else float((a - b).norm())


def bn_forward_fp64(stats_only):
    """A ``_FlaxBatchNorm.forward`` whose batch statistics (and with
    ``stats_only`` False, the whole normalisation) run in fp64."""
    import torch
    from vfs_tpu_torch.models.common.norm import _FlaxBatchNorm
    plain = _FlaxBatchNorm.forward

    def forward(self, x):
        if not self.training:
            return plain(self, x)
        dims = [d for d in range(x.dim()) if d != 1]
        xd = x.to(torch.float64)
        mean = xd.mean(dims)
        var = torch.clamp((xd * xd).mean(dims) - mean * mean, min=0.0)
        if self.update_stats and self.track_running_stats:
            with torch.no_grad():
                m = self.flax_momentum
                self.running_mean.mul_(m).add_((1 - m) * mean.to(x.dtype))
                self.running_var.mul_(m).add_((1 - m) * var.to(x.dtype))
                self.num_batches_tracked.add_(1)
        wide = torch.float64 if not stats_only else x.dtype
        shape = [1] * x.dim()
        shape[1] = x.shape[1]
        mul = torch.rsqrt(var.to(wide) + self.eps) * self.weight.to(wide)
        y = (x.to(wide) - mean.to(wide).view(shape)) * mul.view(shape) \
            + self.bias.to(wide).view(shape)
        return y.to(x.dtype)
    return forward


@contextlib.contextmanager
def variant(name):
    import torch
    from vfs_tpu_torch.models.common.norm import _FlaxBatchNorm
    saved = (_FlaxBatchNorm.forward, torch.backends.cudnn.enabled,
             torch.backends.cudnn.deterministic)
    if name.startswith('bn_fp64'):
        _FlaxBatchNorm.forward = bn_forward_fp64(name == 'bn_fp64_stats')
    torch.backends.cudnn.enabled = name != 'cudnn_off'
    torch.backends.cudnn.deterministic = name == 'cudnn_deterministic'
    try:
        yield
    finally:
        (_FlaxBatchNorm.forward, torch.backends.cudnn.enabled,
         torch.backends.cudnn.deterministic) = saved


def step(cfg_dict, batch, device, dtype, name='default', record=False):
    """One train step: the loss, the gradients and, with ``record``, each
    backbone module's output and each ``F.relu`` input (in call order)
    with their gradients, as fp64 on the CPU."""
    import numpy as np
    import torch
    import chip_smoke
    from vfs_tpu_torch.apis.train import make_train_step
    from vfs_tpu_torch.core.optimizer import build_optimizer
    model, cfg = chip_smoke.build_train_model(cfg_dict, False,
                                              torch.device('cpu'))
    model.to(device=device, dtype=dtype)
    if device.type == 'cuda' and name != 'contiguous':
        model.backbone.to(memory_format=torch.channels_last)
    order, values, grads, relus = [], {}, {}, []

    def keep(key, out):
        order.append(key)
        values[key] = out.detach().double().cpu()
        if out.requires_grad:
            out.register_hook(lambda g: grads.__setitem__(
                key, g.detach().double().cpu()))

    hooks, calls = [], {}
    if record:
        def hook(mname):
            def f(m, args, out):
                calls[mname] = calls.get(mname, -1) + 1
                keep(f'{mname}#{calls[mname]}', out)
            return f
        for mname, m in model.backbone.named_modules():
            if mname:
                hooks.append(m.register_forward_hook(hook(mname)))
    optimizer, _ = build_optimizer(model.parameters(), cfg.optimizer,
                                   cfg.get('lr_config'), 10, 5)
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    try:
        with variant(name), chip_smoke.relu_decisions(
                record=relus if record else None):
            loss = float(make_train_step(model, optimizer)(
                batch.astype(np_dtype))['loss'])
    finally:
        for h in hooks:
            h.remove()
    return dict(loss=loss, order=order, values=values, grads=grads,
                relus=[r.double() for r in relus],
                params={n: p.grad.detach().double().cpu()
                        for n, p in model.named_parameters()})


def compare(run, ref):
    """The run's errors against ``ref``: the parameter rule, every
    recorded tensor's, the ReLU decisions that differ and the first jump
    of the gradient error in backward order."""
    import chip_smoke
    err, name = chip_smoke.grad_error(run['params'], ref['params'])
    tensors = {k: dict(value=rel(run['values'][k], ref['values'][k]),
                       grad=rel(run['grads'][k], ref['grads'][k])
                       if k in ref['grads'] else None)
               for k in ref['order']}
    flips, max_ulps, decisions = 0, 0.0, []
    for call, (x, x64) in enumerate(zip(run['relus'], ref['relus'])):
        differ = (x > 0) != (x64 > 0)
        if differ.any():
            ulp = float(x64.square().mean().sqrt()) * 2.0 ** -23
            flips += int(differ.sum())
            max_ulps = max(max_ulps, float(x64[differ].abs().max()) / ulp)
            for pos in differ.nonzero().tolist()[:2]:
                decisions.append(dict(call=call, position=pos,
                                      fp64=float(x64[tuple(pos)]),
                                      value=float(x[tuple(pos)])))
    jump, after = None, None
    for k in reversed(ref['order']):
        g = tensors[k]['grad']
        if g is None or g == 0.0:
            continue
        if after is not None and g > 100 * after:
            d = (run['grads'][k] - ref['grads'][k]).abs()
            pos = tuple(int(i) for i in divmod_index(int(d.argmax()),
                                                     d.shape))
            jump = dict(tensor=k, grad_error=g, grad_error_after=after,
                        position=pos,
                        value_fp64=float(ref['values'][k][pos]),
                        value=float(run['values'][k][pos]),
                        grad_fp64=float(ref['grads'][k][pos]),
                        grad=float(run['grads'][k][pos]))
            break
        after = g
    return dict(loss=run['loss'], grad_rel_l2=err, worst=name,
                relu_decisions_differ=flips, max_ulps=max_ulps,
                decisions=decisions, jump=jump, tensors=tensors)


def divmod_index(flat, shape):
    out = []
    for n in reversed(shape):
        flat, r = divmod(flat, n)
        out.append(r)
    return reversed(out)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--scan', type=int, default=0)
    parser.add_argument('--out', default=None)
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print('precision_probe: no CUDA device', file=sys.stderr)
        return 2
    import chip_smoke
    from vfs_tpu_torch.utils import Config
    print(chip_smoke.card_line(), flush=True)
    dev, cpu = torch.device('cuda', 0), torch.device('cpu')
    cfg_dict = Config.fromfile(chip_smoke.CONFIG).to_dict()
    os.makedirs(os.path.join(ROOT, 'build'), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, 'build')) as r:
        ann = chip_smoke.write_k400(r, 'mp4v')
        batch = chip_smoke.loader_first_batch(cfg_dict, ann, r,
                                              max(2, 2 * args.scan))
    ref = step(cfg_dict, batch[:2], cpu, torch.float64, record=True)
    dump = {}
    for label, device, name in (
            ('cpu_fp32', cpu, 'default'), ('card_fp32', dev, 'default'),
            ('card_fp32_cudnn_off', dev, 'cudnn_off'),
            ('card_fp32_cudnn_deterministic', dev, 'cudnn_deterministic'),
            ('card_fp32_contiguous', dev, 'contiguous'),
            ('card_fp32_bn_fp64_stats', dev, 'bn_fp64_stats'),
            ('card_fp32_bn_fp64', dev, 'bn_fp64'),
            ('cpu_fp32_bn_fp64', cpu, 'bn_fp64')):
        out = compare(step(cfg_dict, batch[:2], device, torch.float32, name,
                           record=True), ref)
        dump[label] = out
        print(json.dumps({'run': label, **{k: v for k, v in out.items()
                                           if k != 'tensors'}}),
              flush=True)
    for i in range(args.scan):
        b = batch[2 * i:2 * i + 2]
        exact = step(cfg_dict, b, cpu, torch.float64)
        print(json.dumps({'scan': i, **{
            label: chip_smoke.grad_error(
                step(cfg_dict, b, device, torch.float32)['params'],
                exact['params'])
            for label, device in (('cpu_fp32', cpu), ('card_fp32', dev))}}),
            flush=True)
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(dump, f)
    return 0


if __name__ == '__main__':
    sys.exit(main())
