#!/usr/bin/env python3
"""Time the four windowed top-k kernels on one card: two checkouts against
each other, or this checkout's rows 1 and 3 against their ablations.

    python3 ab_kernels.py DIR_A DIR_B
    python3 ab_kernels.py --wide DIR_A DIR_B
    python3 ab_kernels.py --ablate
    python3 ab_kernels.py --modes
    python3 ab_kernels.py --tc
    python3 ab_kernels.py --wgrad3d

Every mode uses the DAVIS-480p shapes of ``chip_smoke.py``'s full phase
(60x107 cells, P=20, top-10; the r18 and r50 widths, seeded random
L2-normalised features made on the card) and times, with
``chip_smoke.cuda_ms`` (median of 5 CUDA-event timings after a warm-up):

- rows 1 (``video_topk_affinity``) and 2 (``video_topk_affinity_v1``,
  with the tau exit on, ``'perframe'``, and off, ``'sweep'``) at T=24 and
  T=48, milliseconds per launch;
- rows 3 (``local_topk_attend``) and 4 (``local_topk_attend_v2``) for one
  step against a full bank of 21 slots (K=4);
- rows 1-3's bf16 entries on the same features cast to bf16 (``_bf16``
  keys).

``DIR_A DIR_B`` runs each checkout's own package in its own process, in
the order A, B, B, A (``ab_eval.run_ab``). The child calls each row with
arguments that older checkouts accept too (no counters; the bf16 rows
need a checkout from slice 8 on). It prints one
JSON line per run with the checkout, the times and a SHA-256 of each
row's outputs (scores and sources, T=48, for rows 1 and 2, both row 2
settings; logits, scores and sources for rows 3 and 4), then one line
saying, row by row, whether the two checkouts' outputs are bit-identical.

``--wide DIR_A DIR_B`` does the same for the wide kernel
(``csrc/window_topk_wide.cu``, rows 1w-4w: the four wrappers past the
core's limits) at ``chip_smoke.WIDE_FULL``'s shapes (r18 width, radius
40 / top-10 and radius 12 / top-48; rows 1w and 2w at T=24, rows 3w and 4w
a step against 21 slots, K=4): row 1w and row 2w (``'perframe'``) on fp32
and bf16 features, row 3w in each mode (exact, ``scores='bfloat16'``,
``extract='packed'``) on fp32 and bf16 features, row 4w on fp32 features;
each entry's median ms over 3 CUDA-event timings and the SHA-256 of its
outputs, then the line saying whether each entry's outputs are
bit-identical across the two checkouts.

``--ablate`` builds this checkout's rows 1 and 3 once as the package does
and once with each switch of ``window_topk.cuh``'s ``WTK_ABLATE`` on
(``ABLATIONS``), then times them in the order full, each ablation, full.
An ablated kernel's outputs are wrong; only its time is read. It prints
one JSON line per variant.

``--modes`` times row 3's inexact mode entries (``scores='bfloat16'``
and ``extract='packed'``, fp32 and bf16 features) against row 3's exact
fp32 entry on the same step, in the order exact, each mode, each mode
again in reverse, exact; one JSON line per width with each entry's
median ms and its ratio to the exact entry.

``--tc`` times row 1's two fp32 paths on the same features, the FFMA
core (``video_affinity.launch_core``) and the tensor-core path
(``video_affinity.launch_tc``, ``csrc/video_topk_tc.cu``), in the order
core, tc, tc, core at T=24 and T=48 for each width, beside the
fp32 bound; holds the tensor-core path's scores and sources bit-identical
to the core's and to row 2's (exit on) at T=24 and T=48, and to the
core's on the near-tie kinds of ``chip_smoke.TC_KINDS`` (T=24); reports
its counters (keys re-scored, queries overflowed) and checks the mma
accumulation model (``chip_smoke.mma_model_check``). One JSON line per
width, then both paths' ms per frame at C of ``TC_SWEEP`` (r18's radius,
T=24: the C crossover), then the model check.

``--wgrad3d`` times the narrow weight-gradient kernel
(``ops/conv3d_wgrad.py::conv3d_weight_cuda``, ``csrc/conv3d_wgrad.cu``)
against cuDNN's weight gradient (``torch.nn.grad.conv3d_weight``, TF32
off) at every distinct convolution of train_slowfast_r50 that the kernel
can take (``chip_smoke.conv3d_shapes``; channels-last seeded X and dY),
then at those of the other 3-D recognizers of
``chip_smoke.WGRAD3D_OTHERS`` (I3D-R50, SlowOnly-R50, ir-CSN-152 at one
card's clips), in the order cuDNN, kernel, kernel, cuDNN (median of 3
CUDA-event timings each): one JSON line per convolution with the model,
both medians, the bound, whether ``conv3d_wgrad.narrow`` routes it and
whether the kernel was the faster; a narrow convolution for which the
kernel has no plan (too wide a window for shared memory) gets cuDNN's
time alone. ``narrow_shape``'s rule comes from
the SlowFast lines; the others check it.

Every mode ends with the card's name and power limit as ``nvidia-smi``
gives them. Needs one card.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import hashlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
H, W, P, TOPK, K_CLASSES, SLOTS = 60, 107, 20, 10, 4, 21
ROWS = (1, 2, 3, 4)
# --tc: the widths of the crossover sweep
TC_SWEEP = (64, 128, 256, 384, 512)
# the ablation builds: rows 1 and 3
KERNELS = ('video_topk_affinity', 'local_topk_attend')
# window_topk.cuh's WTK_ABLATE bits: what each variant leaves out (1 inner
# loop, 2 merges, 4 stage copies, 8 chunk barrier). The inner loop, the
# copies and the barrier are also left out on top of no_merge: without the
# loop or the copies the scores change, and with them the merges' work.
ABLATIONS = {'no_inner_loop': 1, 'no_merge': 2,
             'no_merge_no_inner_loop': 2 | 1,
             'no_merge_no_stage_copies': 2 | 4,
             'no_merge_no_chunk_barrier': 2 | 8,
             'no_merge_loop_copies': 2 | 1 | 4}


def digest(tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def make_inputs(dev, c):
    """Rows 1 and 2's 48 frames, rows 3 and 4's query, bank, values and
    validity."""
    import torch
    from vfs_tpu_torch.ops import l2_normalize
    g = torch.Generator(device=dev).manual_seed(c)
    feats48 = l2_normalize(torch.randn((48, H, W, c), device=dev,
                                       generator=g)).contiguous()
    g = torch.Generator(device=dev).manual_seed(c + 1)
    bank = l2_normalize(torch.randn((SLOTS, H, W, c), device=dev,
                                    generator=g)).contiguous()
    query = l2_normalize(torch.randn((H, W, c), device=dev,
                                     generator=g)).contiguous()
    vals = torch.rand((SLOTS, H, W, K_CLASSES), device=dev, generator=g)
    valid = torch.ones(SLOTS, dtype=torch.int32, device=dev)
    feats48_bf16 = feats48.to(torch.bfloat16)
    return dict(feats48=feats48, feats24=feats48[:24].contiguous(),
                feats48_bf16=feats48_bf16,
                feats24_bf16=feats48_bf16[:24].contiguous(),
                step=(query, bank, vals, valid),
                step_bf16=(query.to(torch.bfloat16),
                           bank.to(torch.bfloat16), vals, valid))


def time_kernels(inputs, radius, cuda_ms, rows=ROWS, hashes=False):
    """Rows ``rows`` on ``inputs``: times, and with ``hashes`` the
    outputs' SHA-256."""
    from vfs_tpu_torch import ops

    def row1(t, feat=''):
        return ops.video_topk_affinity_cuda(inputs[f'feats{t}{feat}'],
                                            radius, 0.07, TOPK, P)

    def row2(extract, early_exit):
        return lambda t, feat='': ops.video_topk_affinity_v1_cuda(
            inputs[f'feats{t}{feat}'], radius, 0.07, TOPK, P,
            early_exit=early_exit, extract=extract)

    video = [(1, 'row1', row1),
             (2, 'row2_exit_on', row2('perframe', True)),
             (2, 'row2_exit_off', row2('sweep', False))]
    step = [(3, 'row3', ops.local_topk_attend_cuda),
            (4, 'row4', ops.local_topk_attend_v2_cuda)]
    out = {}
    for feat in ('', '_bf16'):
        for row, key, fn in video:
            if row not in rows:
                continue
            key += feat
            t24 = cuda_ms(lambda: fn(24, feat))
            t48 = cuda_ms(lambda: fn(48, feat))
            out.update({f'{key}_ms_T24': t24, f'{key}_ms_T48': t48,
                        f'{key}_ms_per_frame_T24': t24 / 23,
                        f'{key}_steady_ms_per_frame': (t48 - t24) / 24})
            if hashes:
                out[f'{key}_sha256'] = digest(fn(48, feat))
        for row, key, fn in step:
            if row not in rows or (feat and row == 4):  # row 4: fp32 only
                continue
            args = (*inputs['step' + feat], radius, 0.07, TOPK)
            out[f'{key}{feat}_ms_per_step'] = cuda_ms(lambda: fn(*args))
            if hashes:
                out[f'{key}{feat}_sha256'] = digest(fn(*args))
    return out


def time_wide(dev, cuda_ms, shapes):
    """Rows 1w-4w at the r18 width for each (radius, topk) of ``shapes``:
    each entry's median ms (3 runs) and the SHA-256 of its outputs."""
    import torch
    from vfs_tpu_torch import ops
    inputs = make_inputs(dev, 256)
    feats = {'': inputs['feats24'], '_bf16': inputs['feats24_bf16']}
    out = {}
    for radius, topk in shapes:
        key = f'radius{radius:g}_top{topk}'
        entries = {}
        for feat, fv in feats.items():
            entries[f'row1w{feat}'] = lambda fv=fv: (
                ops.video_topk_affinity_cuda(fv, radius, 0.07, topk, P))
            entries[f'row2w{feat}'] = lambda fv=fv: (
                ops.video_topk_affinity_v1_cuda(fv, radius, 0.07, topk, P,
                                                extract='perframe'))
            step = inputs['step' + feat]
            for mode, kw in (('exact', {}), ('scores_bf16',
                                             dict(scores='bfloat16')),
                             ('packed', dict(extract='packed'))):
                entries[f'row3w_{mode}{feat}'] = (
                    lambda step=step, kw=kw: ops.local_topk_attend_cuda(
                        *step, radius, 0.07, topk, **kw))
        entries['row4w'] = lambda: ops.local_topk_attend_v2_cuda(
            *inputs['step'], radius, 0.07, topk)
        for name, fn in entries.items():
            out[f'{key}/{name}_ms'] = cuda_ms(fn, runs=3)
            out[f'{key}/{name}_sha256'] = digest(fn())
        torch.cuda.empty_cache()
    return out


def child(wide=False):
    """Run in a checkout: time and hash the four kernels at both widths,
    or (``wide``) rows 1w-4w at the wide shapes."""
    import chip_smoke  # the timers and model widths of this script's tree
    sys.path[0] = os.getcwd()  # the package of the checkout
    import torch
    from vfs_tpu_torch.device import exact_fp32
    dev = torch.device('cuda', 0)
    out = {}
    with exact_fp32():
        if wide:
            out['r18'] = time_wide(dev, chip_smoke.cuda_ms,
                                   chip_smoke.WIDE_FULL)
        else:
            for model, c, radius in chip_smoke.MODELS:
                out[model] = time_kernels(make_inputs(dev, c), radius,
                                          chip_smoke.cuda_ms, hashes=True)
                torch.cuda.empty_cache()
    print(json.dumps(out))


def modes():
    """Row 3's mode entries against its exact fp32 entry, in turns."""
    import statistics

    import chip_smoke
    import torch
    from vfs_tpu_torch.device import exact_fp32
    from vfs_tpu_torch.ops import local_topk_attend_cuda
    entries = {'exact': ('step', {}),
               **{f'{name}{feat}': ('step' + feat, kw)
                  for feat in ('', '_bf16')
                  for name, kw in chip_smoke.LOCAL_MODES}}
    order = list(entries) + list(entries)[:0:-1] + ['exact']
    dev = torch.device('cuda', 0)
    with exact_fp32():
        for model, c, radius in chip_smoke.MODELS:
            inputs = make_inputs(dev, c)
            runs = {}
            for name in order:
                key, kw = entries[name]
                runs.setdefault(name, []).append(chip_smoke.cuda_ms(
                    lambda: local_topk_attend_cuda(
                        *inputs[key], radius, 0.07, TOPK, **kw)))
            ms = {n: statistics.median(r) for n, r in runs.items()}
            print(json.dumps({'model': model, 'ms_per_step': ms,
                              'runs': runs,
                              'vs_exact': {n: v / ms['exact'] - 1.0
                                           for n, v in ms.items()}}),
                  flush=True)
            del inputs
            torch.cuda.empty_cache()
    print(chip_smoke.card_line())


def wgrad3d():
    """The narrow weight-gradient kernel against cuDNN's weight gradient
    at every convolution of train_slowfast_r50 and of the other 3-D
    recognizers that the kernel can take, in turns."""
    import statistics

    import chip_smoke
    import torch
    from vfs_tpu_torch.device import exact_fp32
    from vfs_tpu_torch.ops import conv3d_wgrad as cw
    dev = torch.device('cuda', 0)
    smi_line = chip_smoke.card_line()
    models = {'slowfast_r50_4x16x1': (None, chip_smoke.WGRAD3D_CLIP),
              **chip_smoke.WGRAD3D_OTHERS}
    shapes = [dict(c, model=model)
              for model, (cfg, clip) in models.items()
              for c in chip_smoke.conv3d_shapes(cfg, clip)]
    with exact_fp32():
        for k, c in enumerate(shapes):
            xs, ws, st, pad = c['x'], c['weight'], c['stride'], c['padding']
            if cw.plan(xs, ws, st, pad) is None:
                if c['narrow']:  # narrow, but the kernel has no plan
                    x, dy, w = chip_smoke.wgrad3d_inputs(xs, ws, st, pad,
                                                         dev, k)
                    print(json.dumps({**c, 'kernel_ms': None, 'library_ms':
                                      chip_smoke.cuda_ms(
                                          lambda: torch.nn.grad.conv3d_weight(
                                              x, ws, dy, st, pad), runs=3)}),
                          flush=True)
                    del x, dy, w
                continue
            x, dy, w = chip_smoke.wgrad3d_inputs(xs, ws, st, pad, dev, k)
            paths = {'library': lambda: torch.nn.grad.conv3d_weight(
                         x, ws, dy, st, pad),
                     'kernel': lambda: cw.conv3d_weight_cuda(x, dy, w, st,
                                                             pad)}
            runs = {}
            for name in ('library', 'kernel', 'kernel', 'library'):
                runs.setdefault(name, []).append(
                    chip_smoke.cuda_ms(paths[name], runs=3))
            ms = {n: statistics.median(r) for n, r in runs.items()}
            flops, nbytes = chip_smoke.wgrad3d_work(xs, ws, st, pad)
            print(json.dumps({
                **c, 'kernel_ms': ms['kernel'], 'library_ms': ms['library'],
                'runs': runs, 'kernel_faster': ms['kernel'] < ms['library'],
                'bound_ms': chip_smoke.bound_ms(flops, nbytes, smi_line)[0]}),
                flush=True)
            del x, dy, w
            torch.cuda.empty_cache()
    print(smi_line)


def tensor_cores():
    """Row 1's FFMA core and tensor-core path at both widths, in turns;
    bit-identity and counters; the accumulation model's check."""
    import statistics

    import chip_smoke
    import torch
    from vfs_tpu_torch.device import exact_fp32
    from vfs_tpu_torch.ops import video_topk_affinity_v1_cuda
    from vfs_tpu_torch.ops.video_affinity import launch_core, launch_tc
    dev = torch.device('cuda', 0)
    smi_line = chip_smoke.card_line()
    paths = {'core': launch_core, 'tc': launch_tc}
    with exact_fp32():
        for model, c, radius in chip_smoke.MODELS:
            inputs = make_inputs(dev, c)
            out = {'model': model}
            runs = {}
            for t in (24, 48):
                feats = inputs[f'feats{t}']
                for name in ('core', 'tc', 'tc', 'core'):
                    runs.setdefault(f'{name}_T{t}', []).append(
                        chip_smoke.cuda_ms(lambda: paths[name](
                            feats, radius, 0.07, TOPK, P)))
                got, counts = chip_smoke.tc_counted(feats, radius, TOPK, P)
                out[f'T{t}_bit_identical_to_core'] = chip_smoke.tc_same(
                    got, launch_core(feats, radius, 0.07, TOPK, P))
                out[f'T{t}_bit_identical_to_row2'] = chip_smoke.tc_same(
                    got, video_topk_affinity_v1_cuda(feats, radius, 0.07,
                                                     TOPK, P))
                out[f'T{t}_counts'] = counts
            ms = {k: statistics.median(v) for k, v in runs.items()}
            f24 = chip_smoke.affinity_work(24, H, W, c, radius, TOPK, P)[0]
            f48 = chip_smoke.affinity_work(48, H, W, c, radius, TOPK, P)[0]
            for name in paths:
                per_frame = ms[f'{name}_T24'] / 23
                steady = (ms[f'{name}_T48'] - ms[f'{name}_T24']) / 24
                bound = chip_smoke.bound_ms(f24 / 23, 0.0, smi_line)[0]
                bound_steady = chip_smoke.bound_ms((f48 - f24) / 24, 0.0,
                                                   smi_line)[0]
                out[name] = dict(ms_per_frame_T24=per_frame,
                                 steady_ms_per_frame=steady,
                                 bound_ms_per_frame_T24=bound,
                                 bound_share_T24=bound / per_frame,
                                 steady_bound_share=bound_steady / steady)
            out['runs'] = runs
            del inputs
            torch.cuda.empty_cache()
            for kind in chip_smoke.TC_KINDS[1:]:
                feats = chip_smoke.tc_feats(dev, kind, 24, H, W, c, c)
                got, counts = chip_smoke.tc_counted(feats, radius, TOPK, P)
                out[f'{kind}_bit_identical_to_core'] = chip_smoke.tc_same(
                    got, launch_core(feats, radius, 0.07, TOPK, P))
                out[f'{kind}_counts'] = counts
                out[f'{kind}_tc_ms_T24'] = chip_smoke.cuda_ms(
                    lambda: launch_tc(feats, radius, 0.07, TOPK, P), runs=3)
                del feats, got
                torch.cuda.empty_cache()
            print(json.dumps(out), flush=True)
        # the C crossover (window_geometry.TC_MIN_CHANNELS): both paths at
        # the r18 window, T=24, narrower and wider than its 256 channels
        sweep = {}
        for c in TC_SWEEP:
            inputs = make_inputs(dev, c)
            feats = inputs['feats24']
            runs = {}
            for name in ('core', 'tc', 'tc', 'core'):
                runs.setdefault(name, []).append(chip_smoke.cuda_ms(
                    lambda: paths[name](feats, 12.0, 0.07, TOPK, P), runs=3))
            sweep[c] = {k: statistics.median(v) / 23 for k, v in runs.items()}
            del inputs, feats
            torch.cuda.empty_cache()
        print(json.dumps({'crossover_ms_per_frame_T24_radius12': sweep}))
    print(json.dumps({'mma_model': chip_smoke.mma_model_check(dev)}))
    print(smi_line)


def ablate():
    """This checkout's rows 1 and 3 and their ablations, in the order
    full, each ablation, full."""
    import chip_smoke
    import torch
    from vfs_tpu_torch.device import exact_fp32
    from vfs_tpu_torch.ops import _build
    variants = {'full': (), **{name: (f'WTK_ABLATE={bit}',)
                               for name, bit in ABLATIONS.items()}}
    jobs = [(name, v) for name in KERNELS for v in variants.values()]
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        paths = dict(zip(jobs, pool.map(lambda j: _build.build(*j), jobs)))
    dev = torch.device('cuda', 0)
    smi_line = chip_smoke.card_line()
    with exact_fp32():
        for model, c, radius in chip_smoke.MODELS:
            inputs = make_inputs(dev, c)
            runs = {}
            for variant in ['full', *ABLATIONS, 'full']:
                for name in KERNELS:  # what the wrappers' _library() loads
                    _build._LIBS[name] = ctypes.CDLL(
                        str(paths[name, variants[variant]]))
                run = time_kernels(inputs, radius, chip_smoke.cuda_ms,
                                   rows=(1, 3))
                runs.setdefault(variant, []).append(run)
                print(json.dumps({'model': model, 'variant': variant, **run}),
                      flush=True)
            del inputs
            torch.cuda.empty_cache()
            print(json.dumps({'model': model, **split(runs, c, radius,
                                                      smi_line)}))
    print(smi_line)


def split(runs, c, radius, smi_line):
    """Each part's milliseconds (the difference of two variants) and share
    of the full kernel's time (the mean of its two runs), for row 1 per
    frame (T=24 and steady) and row 3 per step; and the rate of the inner
    loop's FFMAs: the time they would take at the fp32 peak (every pair
    the warps compute, ``chip_smoke.pairs_needed_share``) over the inner
    loop's time."""
    import chip_smoke
    keys = ('row1_ms_per_frame_T24', 'row1_steady_ms_per_frame',
            'row3_ms_per_step')
    ms = {v: {k: sum(r[k] for r in rs) / len(rs) for k in keys}
          for v, rs in runs.items()}
    parts = {'merges': ('full', 'no_merge'),
             'inner_loop': ('no_merge', 'no_merge_no_inner_loop'),
             'stage_copies': ('no_merge', 'no_merge_no_stage_copies'),
             'chunk_barrier': ('no_merge', 'no_merge_no_chunk_barrier'),
             'copies_without_loop': ('no_merge_no_inner_loop',
                                     'no_merge_loop_copies')}
    out = {}
    for k in keys:
        part_ms = {p: ms[a][k] - ms[b][k] for p, (a, b) in parts.items()}
        part_ms['rest'] = ms['no_merge_loop_copies'][k]
        out[k] = {'full_ms': ms['full'][k], 'ms': part_ms,
                  'share': {p: v / ms['full'][k]
                            for p, v in part_ms.items()}}
    # FLOPs of every computed pair, per frame (row 1) or step (row 3)
    needed = chip_smoke.pairs_needed_share(H, W, radius)
    f24 = chip_smoke.affinity_work(24, H, W, c, radius, TOPK, P)[0]
    f48 = chip_smoke.affinity_work(48, H, W, c, radius, TOPK, P)[0]
    step = 2.0 * c * chip_smoke.window_pairs(H, W, radius) * SLOTS
    for k, flops in zip(keys, (f24 / 23, (f48 - f24) / 24, step)):
        peak_ms = chip_smoke.bound_ms(flops / needed, 0.0, smi_line)[0]
        out[k]['inner_loop_ffma_peak_share'] = (
            peak_ms / out[k]['ms']['inner_loop'])
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('checkouts', nargs='*')
    parser.add_argument('--ablate', action='store_true')
    parser.add_argument('--modes', action='store_true')
    parser.add_argument('--wide', action='store_true')
    parser.add_argument('--tc', action='store_true')
    parser.add_argument('--wgrad3d', action='store_true')
    parser.add_argument('--child', action='store_true', help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.child:
        return child(args.wide)
    if args.ablate:
        return ablate()
    if args.modes:
        return modes()
    if args.tc:
        return tensor_cores()
    if args.wgrad3d:
        return wgrad3d()
    if len(args.checkouts) != 2:
        parser.error('give two checkouts or --ablate')
    import ab_eval
    import chip_smoke
    a, b = (os.path.abspath(c) for c in args.checkouts)
    hashes = {}
    argv = [os.path.abspath(__file__), '--child'] + ['--wide'] * args.wide
    for checkout, run in ab_eval.run_ab(a, b, argv, 'the kernels'):
        hashes.setdefault(checkout, {}).update(
            (f'{model}/{k}', v) for model, keys in run.items()
            for k, v in keys.items() if k.endswith('sha256'))
        print(json.dumps({'checkout': os.path.relpath(checkout, ROOT),
                          **run}), flush=True)
    same = {k: hashes[a][k] == hashes[b].get(k) for k in sorted(hashes[a])}
    print(json.dumps({'outputs_bit_identical': all(same.values()),
                      'by_row': same}))
    print(chip_smoke.card_line())


if __name__ == '__main__':
    sys.exit(main())
