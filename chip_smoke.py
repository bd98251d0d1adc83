#!/usr/bin/env python3
"""Run vfs_tpu_torch's paths on one CUDA card and hold every kernel against
its plain PyTorch version.

    python3 chip_smoke.py            # every phase, on one card

Phases, one JSON line each on stdout:

1. build: compile the package's CUDA sources (``nvcc``, sm_90a), one
   ``nvcc`` per source, all started together; each one's ``ptxas``
   registers and spills. Then the card's name and power limit as
   ``nvidia-smi`` gives them.
2. small: each kernel vs its plain version over a small-shape matrix:
   ``video_topk_affinity`` over the CPU tests' cases plus a
   duplicated-frame tie case; ``local_topk_attend`` over odd maps,
   invalid slots, top-k up to its maximum, K = 4 and 16, filler entries
   and a duplicated-frame tie case.
3. full: both kernels at the r18 (C=256, radius 12) and r50 (C=1024,
   radius 18) DAVIS-480p shapes (60x107 cells, P=20, top-10) with
   CUDA-event timings (median of 5 after a warm-up), the work and the
   bound. ``video_topk_affinity`` at T=24 and T=48; ``local_topk_attend``
   for one step against a full bank (F=21 slots, K=4).
4. main: slice 1's path, DAVIS label-propagation eval of the r18 model of
   configs/r18_nc_sgd_cos_100e_r2_1xNx8_k400.py at full width with seeded
   random weights, on a synthetic 48x480x854 two-object video, through
   ``build_model(...).forward_test``; ``video_topk_affinity``'s launch
   count must rise and the masks must agree with a run whose phase 1 is
   the plain version.
5. eval: slice 2's path, the config-driven DAVIS eval of the r50 model
   (configs/r50_nc_sgd_cos_100e_r5_1xNx2_k400.py, full width, seeded
   random weights saved as a torchvision-layout ``.pth``) through
   ``python -m vfs_tpu_torch.tools.test``, run in-process with
   ``test_cfg.backend=pallas`` on a synthetic DAVIS-layout dataset of two
   48x480x854 videos written to a temporary directory under ``build/``.
   ``local_topk_attend`` must launch once per step (2 x 47), the masks
   must agree with the same command under ``backend=pallas_video`` and, on
   one video, with a run whose per-step attention is the plain version.
   The counted run's stage times come from CUDA events around
   ``VanillaTracker._extract_feats`` and ``propagate_video``.
6. kernels: every kernel with its launches on its path, times and bound.

The last line is ``{"ok": true, "device": {...}}``; any failure raises and
exits non-zero before it. Without a CUDA device the script exits 2.

Tolerances. The kernels sum each 256/1024-term dot product with fmaf in
channel order; the plain versions use a cuBLAS fp32 matrix product (TF32
off), which sums in another order. Scores therefore differ by ~1e-6
absolute (scores are cosines / 0.07, |s| <= 14.3): checked at rtol 1e-5,
atol 1e-5. Two candidates whose scores lie that close may swap places,
so sources must agree on >= 99.99% of entries (exactly on the tie cases,
where the equal scores are bit-identical in both versions). The per-step
logits are checked at rtol 1e-5 / atol 1e-5 on the cells whose sources
agree; masks of the paths on >= 99.9% of pixels.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, 'configs', 'r18_nc_sgd_cos_100e_r2_1xNx8_k400.py')
CONFIG_R50 = os.path.join(ROOT, 'configs',
                          'r50_nc_sgd_cos_100e_r5_1xNx2_k400.py')

# (fp32 CUDA-core TFLOP/s, device-memory TB/s), NVIDIA data sheets, dense,
# at the full power limit; first matching name wins
PEAKS = [('H100 PCIe', 51.0, 2.0), ('H100 NVL', 60.0, 3.9),
         ('H100', 67.0, 3.35)]

# the CPU tests' small-shape matrix: (T, h, w, neighbor_range, P, topk)
SMALL_CASES = [(9, 6, 7, 6, 4, 5), (12, 8, 8, 6, 4, 3), (6, 5, 9, 8, 3, 4),
               (12, 8, 9, 6, 1, 5), (2, 5, 6, 6, 4, 3), (10, 8, 9, 6, 4, 5),
               (4, 2, 3, 4, 2, 12)]  # the last has filler entries
NO_LIBRARY_CALL = ('no single PyTorch call computes a masked windowed '
                   'top-k over a frame bank')
KERNEL_INFO = dict(
    name='video_topk_affinity', route='cuda',
    source='vfs_tpu_torch/csrc/video_topk_affinity.cu',
    replaces='vfs_tpu/ops/pallas_affinity_video.py:1037')
LOCAL_INFO = dict(
    name='local_topk_attend', route='cuda',
    source='vfs_tpu_torch/csrc/local_topk_attend.cu',
    replaces='vfs_tpu/ops/pallas_attention.py:357')
# local_topk_attend's small matrix: (h, w, C, radius, slot validity, topk,
# K); the kernel keeps at most 32 entries per query
LOCAL_CASES = [(7, 9, 8, 3.0, (1, 1, 1, 0, 0), 5, 4),
               (11, 13, 16, 4.0, (1, 0, 1, 1, 0, 1), 32, 16),
               (9, 40, 12, 5.0, (0, 1, 1, 1), 10, 4),
               (5, 6, 8, 18.0, (1, 1, 0), 10, 16),
               (2, 3, 8, 2.0, (1, 0, 1), 12, 4)]  # the last has fillers


def emit(obj):
    print(json.dumps(obj), flush=True)


def peaks(name):
    for key, tflops, tbps in PEAKS:
        if key in name:
            return tflops, tbps
    return PEAKS[2][1:]


def cuda_ms(fn, runs=5, warmup=1):
    """Median milliseconds of ``fn`` over ``runs`` CUDA-event timings."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def affinity_work(t_total, h, w, c, radius, topk, p):
    """FLOPs and bytes the affinity needs for these inputs: 2*C per (query,
    distinct live bank frame, in-map window key); features read once,
    outputs written once. Frame t's bank holds min(t, P+1) distinct frames:
    while t <= P frame 0 sits at both j=0 and ring slot 0, and its two
    scores are the same numbers, so the function needs them once."""
    live = sum(min(t, p + 1) for t in range(1, t_total))
    flops = 2.0 * c * window_pairs(h, w, radius) * live
    nbytes = 4.0 * t_total * h * w * c + 12.0 * (t_total - 1) * h * w * topk
    return flops, nbytes


def window_pairs(h, w, radius):
    """(query, key) pairs of one frame pair: keys in the circle and the
    map."""
    from vfs_tpu_torch.ops.video_affinity import circle_offsets
    _, dy, dx = circle_offsets(radius)
    ys, xs = np.arange(h)[:, None, None], np.arange(w)[None, :, None]
    ky, kx = ys + dy.numpy(), xs + dx.numpy()
    return int(((ky >= 0) & (ky < h) & (kx >= 0) & (kx < w)).sum())


def step_work(h, w, c, radius, topk, k_classes, n_slots, distinct):
    """FLOPs and bytes one per-step attention needs: 2*C per (query,
    distinct valid bank frame, in-map window key) plus the 2*k*K-term
    weighted sum per query; the query, the bank's slots and values read
    once, the logits, scores and sources written once."""
    hw = h * w
    flops = (2.0 * c * window_pairs(h, w, radius) * distinct
             + 2.0 * hw * topk * k_classes)
    nbytes = (4.0 * hw * c * (1 + n_slots) + 4.0 * n_slots * hw * k_classes
              + 4.0 * hw * k_classes + 12.0 * hw * topk)
    return flops, nbytes


def bound_ms(flops, nbytes, name):
    tflops, tbps = peaks(name)
    by_ops = flops / (tflops * 1e12) * 1e3
    by_bytes = nbytes / (tbps * 1e12) * 1e3
    return max(by_ops, by_bytes), ('operations' if by_ops >= by_bytes
                                   else 'bytes')


def compare(kernel, plain, exact_src, what):
    """Kernel vs plain (scores, sources). Returns (max_abs_err, number of
    differing sources, their share) and raises past the tolerances."""
    import torch
    ks, ki = kernel
    ps, pi = plain
    if not torch.isfinite(ks).all():
        raise AssertionError(f'{what}: non-finite kernel scores')
    err = float((ks - ps).abs().max()) if ks.numel() else 0.0
    mismatch = int((ki != pi).sum())
    share = mismatch / max(1, ki.numel())
    if not torch.allclose(ks, ps, rtol=1e-5, atol=1e-5):
        raise AssertionError(f'{what}: scores differ, max abs err {err}')
    if exact_src and mismatch:
        raise AssertionError(f'{what}: {mismatch} tie-case sources differ')
    if share > 1e-4:
        raise AssertionError(f'{what}: {mismatch} sources differ '
                             f'({share} > 1e-4)')
    return err, mismatch, share


def compare_local(kernel, plain, exact_src, what):
    """Per-step kernel vs plain (logits, scores, sources). Returns
    (max |score diff|, max |logit diff|, differing sources, their share);
    logits are held to the tolerance on the cells whose sources agree."""
    import torch
    (ko, ks, ki), (po, ps, pi) = kernel, plain
    err, mismatch, share = compare((ks, ki), (ps, pi), exact_src, what)
    if not torch.isfinite(ko).all():
        raise AssertionError(f'{what}: non-finite kernel logits')
    logit_err = float((ko - po).abs().max())
    same = (ki == pi).all(-1)
    if not torch.allclose(ko[same], po[same], rtol=1e-5, atol=1e-5):
        raise AssertionError(f'{what}: logits differ, max abs err '
                             f'{float((ko[same] - po[same]).abs().max())}')
    return err, logit_err, mismatch, share


def phase_build():
    """Build every kernel, one nvcc per source, all started together."""
    from vfs_tpu_torch.ops import _build
    names = [KERNEL_INFO['name'], LOCAL_INFO['name']]
    t0 = time.time()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        libs = dict(zip(names, pool.map(_build.build, names)))
    secs = time.time() - t0
    ptxas = {name: [ln.strip()
                    for ln in lib.with_suffix('.log').read_text().splitlines()
                    if 'registers' in ln or 'spill' in ln]
             for name, lib in libs.items()}
    emit({'phase': 'build', 'seconds': secs, 'ptxas': ptxas})
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True, check=True)
    smi_line = smi.stdout.strip().splitlines()[0]
    print(smi_line, flush=True)
    return smi_line


def run_case(feats, radius, topk, p, exact_src, what):
    from vfs_tpu_torch.ops import (video_topk_affinity_cuda,
                                   video_topk_affinity_reference)
    out_k = video_topk_affinity_cuda(feats, radius, 0.07, topk, p)
    out_p = video_topk_affinity_reference(feats, radius, 0.07, topk, p)
    import torch
    torch.cuda.synchronize()
    return compare((out_k[0][1:], out_k[1][1:]), (out_p[0][1:], out_p[1][1:]),
                   exact_src, what)


def run_local(query, bank, vals, valid, radius, topk, exact_src, what):
    """local_topk_attend's kernel vs its plain version (TF32 off); returns
    compare_local's numbers and the kernel's outputs."""
    import torch
    from vfs_tpu_torch.device import exact_fp32
    from vfs_tpu_torch.ops import (local_topk_attend_cuda,
                                   local_topk_attend_reference)
    with exact_fp32():
        out_k = local_topk_attend_cuda(query, bank, vals, valid, radius, 0.07,
                                       topk)
        out_p = local_topk_attend_reference(query, bank, vals, valid, radius,
                                            0.07, topk)
    torch.cuda.synchronize()
    return compare_local(out_k, out_p, exact_src, what), out_k


def phase_small(dev):
    import torch
    from vfs_tpu_torch.ops import l2_normalize
    results = []
    for t_total, h, w, nr, p, topk in SMALL_CASES:
        rng = np.random.RandomState(t_total * 100 + h)
        feats = l2_normalize(torch.tensor(rng.randn(t_total, h, w, 8),
                                          dtype=torch.float32, device=dev))
        err, mismatch, _ = run_case(feats.contiguous(), float(nr // 2),
                                    topk, p, False,
                                    f'small {t_total}x{h}x{w} P={p}')
        results.append([t_total, h, w, nr, p, topk, err, mismatch])
    rng = np.random.RandomState(17)
    feats = rng.randn(10, 8, 9, 8)
    feats[3] = feats[1]
    feats[7] = feats[5]
    feats = l2_normalize(torch.tensor(feats, dtype=torch.float32,
                                      device=dev)).contiguous()
    err, mismatch, _ = run_case(feats, 3.0, 5, 4, True, 'tie case')
    emit({'phase': 'small', 'kernel': KERNEL_INFO['name'],
          'columns': ['T', 'h', 'w', 'neighbor_range', 'P', 'topk',
                      'max_abs_err', 'src_mismatch'],
          'cases': results,
          'tie_case': {'max_abs_err': err, 'src_mismatch': mismatch}})

    def tensor(a, dtype=torch.float32):
        return torch.tensor(a, dtype=dtype, device=dev)

    results = []
    fillers = 0
    for h, w, c, radius, valid, topk, k in LOCAL_CASES:
        rng = np.random.RandomState(h * 100 + w)
        f = len(valid)
        query = l2_normalize(tensor(rng.randn(h, w, c))).contiguous()
        bank = l2_normalize(tensor(rng.randn(f, h, w, c))).contiguous()
        vals = tensor(rng.rand(f, h, w, k))
        (err, logit_err, mismatch, _), out = run_local(
            query, bank, vals, tensor(valid, torch.int32), radius, topk,
            False, f'small local {h}x{w} F={f} k={topk} K={k}')
        fillers += int((out[1] <= -1e29).sum())
        results.append([h, w, c, radius, f, sum(valid), topk, k, err,
                        logit_err, mismatch])
    if not fillers:
        raise AssertionError('the filler case produced no filler entries')
    rng = np.random.RandomState(23)
    bank = rng.randn(4, 8, 9, 8)
    bank[2], bank[3] = bank[0], bank[1]
    bank = l2_normalize(tensor(bank)).contiguous()
    query = l2_normalize(tensor(rng.randn(8, 9, 8))).contiguous()
    (err, logit_err, mismatch, _), out = run_local(
        query, bank, tensor(rng.rand(4, 8, 9, 4)),
        tensor([1, 1, 1, 1], torch.int32), 3.0, 5, True, 'local tie case')
    slot, cell = out[2] // 72, out[2] % 72
    if not ((slot[..., :-1] == 0) & (slot[..., 1:] == 2)
            & (cell[..., :-1] == cell[..., 1:])).any():
        raise AssertionError('the local tie case holds no tie')
    emit({'phase': 'small', 'kernel': LOCAL_INFO['name'],
          'columns': ['h', 'w', 'C', 'radius', 'F', 'valid', 'topk', 'K',
                      'max_abs_err', 'max_logit_err', 'src_mismatch'],
          'cases': results, 'filler_entries': fillers,
          'tie_case': {'max_abs_err': err, 'max_logit_err': logit_err,
                       'src_mismatch': mismatch}})


def phase_full(dev, smi_name):
    """video_topk_affinity: correctness at T=24; times at T=24 and T=48.
    Frames 24..47 all see the full bank (P+1 frames), so (time(48) -
    time(24)) / 24 is the steady-state time per frame. local_topk_attend:
    one step against a full bank of 21 distinct random frames, the
    steady state of the scan. Returns the r50 local_topk_attend numbers,
    the kernels line's."""
    import torch
    from vfs_tpu_torch.device import exact_fp32
    from vfs_tpu_torch.ops import (l2_normalize, local_topk_attend_cuda,
                                   local_topk_attend_reference,
                                   video_topk_affinity_cuda,
                                   video_topk_affinity_reference)
    out = {}
    h, w, p, topk = 60, 107, 20, 10
    for model, c, radius in (('r18', 256, 12.0), ('r50', 1024, 18.0)):
        g = torch.Generator(device=dev).manual_seed(c)
        feats48 = l2_normalize(torch.randn((48, h, w, c), device=dev,
                                           generator=g)).contiguous()
        feats24 = feats48[:24].contiguous()
        res = {}
        with exact_fp32():
            err, mismatch, share = run_case(feats24, radius, topk, p, False,
                                            f'full {model}')
            for t_total, feats in ((24, feats24), (48, feats48)):
                res[t_total] = (
                    cuda_ms(lambda: video_topk_affinity_cuda(
                        feats, radius, 0.07, topk, p)),
                    cuda_ms(lambda: video_topk_affinity_reference(
                        feats, radius, 0.07, topk, p)),
                    *affinity_work(t_total, h, w, c, radius, topk, p))
        (k24, p24, f24, b24), (k48, p48, f48, b48) = res[24], res[48]
        b_ms, b_by = bound_ms(f24, b24, smi_name)
        sb_ms, _ = bound_ms((f48 - f24) / 24, (b48 - b24) / 24, smi_name)
        out[model] = dict(
            shape=[24, h, w, c], radius=radius, precede_frames=p, topk=topk,
            max_abs_err=err, src_mismatch=mismatch,
            src_mismatch_share=share,
            kernel_ms_per_frame=k24 / 23, plain_ms_per_frame=p24 / 23,
            gflop_per_frame=f24 / 23 / 1e9, bound_ms_per_frame=b_ms / 23,
            bound_by=b_by,
            steady_kernel_ms_per_frame=(k48 - k24) / 24,
            steady_plain_ms_per_frame=(p48 - p24) / 24,
            steady_gflop_per_frame=(f48 - f24) / 24 / 1e9,
            steady_bound_ms_per_frame=sb_ms,
            library_ms=None, library_note=NO_LIBRARY_CALL)
        del feats48, feats24
        torch.cuda.empty_cache()
    emit({'phase': 'full', 'kernel': KERNEL_INFO['name'], **out})

    out = {}
    f, k_classes = p + 1, 4
    for model, c, radius in (('r18', 256, 12.0), ('r50', 1024, 18.0)):
        g = torch.Generator(device=dev).manual_seed(c + 1)
        bank = l2_normalize(torch.randn((f, h, w, c), device=dev,
                                        generator=g)).contiguous()
        query = l2_normalize(torch.randn((h, w, c), device=dev,
                                         generator=g)).contiguous()
        vals = torch.rand((f, h, w, k_classes), device=dev, generator=g)
        valid = torch.ones(f, dtype=torch.int32, device=dev)
        (err, logit_err, mismatch, share), _ = run_local(
            query, bank, vals, valid, radius, topk, False, f'full local {model}')

        def call(fn):
            return fn(query, bank, vals, valid, radius, 0.07, topk)

        with exact_fp32():
            kernel_ms = cuda_ms(lambda: call(local_topk_attend_cuda))
            plain_ms = cuda_ms(lambda: call(local_topk_attend_reference))
        flops, nbytes = step_work(h, w, c, radius, topk, k_classes, f, f)
        b_ms, b_by = bound_ms(flops, nbytes, smi_name)
        out[model] = dict(
            h=h, w=w, C=c, radius=radius, F=f, topk=topk, K=k_classes,
            max_abs_err=err, max_logit_err=logit_err, src_mismatch=mismatch,
            src_mismatch_share=share, kernel_ms_per_step=kernel_ms,
            plain_ms_per_step=plain_ms, gflop_per_step=flops / 1e9,
            bound_ms_per_step=b_ms, bound_by=b_by, library_ms=None,
            library_note=NO_LIBRARY_CALL)
        del bank, query, vals
        torch.cuda.empty_cache()
    emit({'phase': 'full', 'kernel': LOCAL_INFO['name'], **out})
    return out['r50']


def synthetic_video(t_total=48, h=480, w=854, seed=0):
    """uint8 (T, H, W, 3) textured background with two coloured objects
    moving across it, and their (T, H, W) label maps."""
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 90, (h // 8, w // 8, 3)).astype(np.uint8)
    base = np.repeat(np.repeat(base, 8, 0), 8, 1)
    base = np.pad(base, ((0, h - base.shape[0]), (0, w - base.shape[1]),
                         (0, 0)), mode='edge')
    imgs = np.empty((t_total, h, w, 3), np.uint8)
    labels = np.zeros((t_total, h, w), np.uint8)
    yy, xx = np.mgrid[:h, :w]
    for t in range(t_total):
        img = base.copy()
        cy, cx = 160 + 2 * t, 200 + 5 * t  # a disc moving right and down
        disc = (yy - cy)**2 + (xx - cx)**2 < 70**2
        img[disc] = [220, 50, 40]
        labels[t][disc] = 1
        y2, x2 = 300, 620 - 4 * t          # a box moving left
        box = (slice(y2, y2 + 110), slice(x2, x2 + 130))
        img[box] = [40, 200, 70]
        labels[t][box] = 2
        imgs[t] = img
    return imgs, labels


def phase_main(dev, smi_name):
    import runpy
    import torch
    from vfs_tpu_torch.core.evaluation import (aggregate_metrics,
                                               evaluate_semisupervised)
    from vfs_tpu_torch.device import exact_fp32
    from vfs_tpu_torch.models import build_model
    from vfs_tpu_torch.models.trackers.vanilla_tracker import (
        decode_predictions, make_propagation_config)
    from vfs_tpu_torch.ops import (l2_normalize, propagate_labels,
                                   video_topk_affinity,
                                   video_topk_affinity_cuda,
                                   video_topk_affinity_reference)

    cfg = runpy.run_path(CONFIG)
    test_cfg = dict(cfg['test_cfg'])
    model = build_model(dict(type='VanillaTracker',
                             backbone=dict(cfg['model']['backbone'])),
                        test_cfg=test_cfg)
    model.init_weights(torch.Generator().manual_seed(0))
    imgs, gt = synthetic_video()
    t_total = imgs.shape[0]
    meta = [dict(original_shape=imgs.shape[1:3],
                 img_norm_cfg=dict(cfg['img_norm_cfg']))]

    # the main path, counted
    video_topk_affinity_cuda.launches = 0
    t0 = time.time()
    preds = model.forward_test(imgs, gt[0], meta)[0]
    torch.cuda.synchronize()
    first_s = time.time() - t0
    launches = video_topk_affinity_cuda.launches
    if launches < 1:
        raise AssertionError('the main path did not launch the kernel')
    if preds.shape != gt.shape or preds.dtype != np.uint8 \
            or preds.max() > 2:
        raise AssertionError(f'bad predictions {preds.shape} {preds.dtype}')

    # end to end, warm
    t0 = time.time()
    model.forward_test(imgs, gt[0], meta)
    torch.cuda.synchronize()
    e2e_s = time.time() - t0

    # per stage, warm, on the card
    imgs_dev = torch.as_tensor(imgs, device=dev)
    norm = meta[0]['img_norm_cfg']
    mean = torch.tensor(norm['mean'], dtype=torch.float32, device=dev)
    std = torch.tensor(norm['std'], dtype=torch.float32, device=dev)
    batch_step = int(test_cfg.get('batch_step', 20))
    extract_ms = cuda_ms(lambda: model._extract_feats(
        imgs_dev, batch_step, mean, std))
    feats = model._extract_feats(imgs_dev, batch_step, mean, std)[0]
    h, w = feats.shape[1:3]
    pcfg, _ = make_propagation_config(test_cfg, h, w)
    radius = float(pcfg.neighbor_range // 2)
    feats_n = l2_normalize(feats).contiguous()

    def affinity(fn):
        return fn(feats_n, radius, pcfg.temperature, pcfg.topk,
                  pcfg.precede_frames)

    from vfs_tpu_torch.ops.resize import pil_nearest_resize
    resized = pil_nearest_resize(gt[0].astype(np.float32),
                                 (h, w)).astype(np.int64)
    seg_first = torch.as_tensor(np.eye(4, dtype=np.float32)[resized],
                                device=dev)
    class_valid = torch.as_tensor(np.arange(4) < 3, device=dev)

    with exact_fp32():
        out_k = affinity(video_topk_affinity)
        out_p = affinity(video_topk_affinity_reference)
        err, mismatch, _ = compare((out_k[0][1:], out_k[1][1:]),
                                   (out_p[0][1:], out_p[1][1:]), False,
                                   'main path affinity')
        affinity_ms = cuda_ms(lambda: affinity(video_topk_affinity_cuda))
        plain_ms = cuda_ms(lambda: affinity(video_topk_affinity_reference))

        def gather_decode(out):
            logits = propagate_labels(out[0], out[1], seg_first)
            return decode_predictions(logits, gt.shape[1:], class_valid)

        decode_ms = cuda_ms(lambda: gather_decode(out_k))
        preds_plain = gather_decode(out_p).cpu().numpy()
    preds_plain[0] = gt[0]
    mask_agree = float((preds_plain == preds).mean())
    if mask_agree < 0.999:
        raise AssertionError(f'masks agree on {mask_agree} < 0.999 with the '
                             'plain phase 1')
    metrics = aggregate_metrics({'synthetic': evaluate_semisupervised(
        gt.astype(np.int64), preds.astype(np.int64))})
    jf = (np.mean(metrics['J']['M']) + np.mean(metrics['F']['M'])) / 2
    if not 0.0 <= jf <= 1.0:
        raise AssertionError(f'J&F {jf} out of range')

    c = feats.shape[-1]
    flops, nbytes = affinity_work(t_total, h, w, c, radius, pcfg.topk,
                                  pcfg.precede_frames)
    b_ms, b_by = bound_ms(flops, nbytes, smi_name)
    emit({'phase': 'main', 'video': list(imgs.shape), 'features':
          list(feats.shape), 'first_call_s': first_s,
          'e2e_fps': t_total / e2e_s, 'e2e_ms_per_frame': e2e_s * 1e3
          / t_total, 'extract_ms_per_frame': extract_ms / t_total,
          'affinity_ms_per_frame': affinity_ms / (t_total - 1),
          'gather_decode_ms_per_frame': decode_ms / t_total,
          'mask_agree_plain': mask_agree, 'jf_synthetic': float(jf),
          'kernel_launches': launches})
    return [dict(
        **KERNEL_INFO, launches=launches, max_abs_err=err,
        src_mismatch=mismatch, ms=affinity_ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=None, library_note=NO_LIBRARY_CALL)]


def write_davis(root, n_videos=2, t_total=48):
    """A DAVIS-layout dataset of synthetic videos under ``root``: JPEG
    frames, palette-PNG annotations and two list files (every video; the
    first alone). Video v uses ``synthetic_video(seed=v)``, mirrored for
    odd v so the objects move the other way."""
    from PIL import Image
    from vfs_tpu_torch.datasets.davis_dataset import PALETTE
    img_root = os.path.join(root, 'JPEGImages', '480p')
    ann_root = os.path.join(root, 'Annotations', '480p')
    palette = np.asarray(PALETTE, np.uint8).ravel()
    lines = []
    for v in range(n_videos):
        imgs, labels = synthetic_video(t_total, seed=v)
        if v % 2:
            imgs, labels = imgs[:, :, ::-1], labels[:, :, ::-1]
        name = f'video{v}'
        os.makedirs(os.path.join(img_root, name))
        os.makedirs(os.path.join(ann_root, name))
        for t in range(t_total):
            Image.fromarray(np.ascontiguousarray(imgs[t])).save(
                os.path.join(img_root, name, f'{t:05}.jpg'), quality=95)
            ann = Image.fromarray(np.ascontiguousarray(labels[t]))
            ann.putpalette(palette)
            ann.save(os.path.join(ann_root, name, f'{t:05}.png'))
        lines.append(f'{name} {t_total} 0\n')
    lists = []
    for fname, chosen in (('val_list.txt', lines), ('val_one.txt', lines[:1])):
        lists.append(os.path.join(root, fname))
        with open(lists[-1], 'w') as f:
            f.writelines(chosen)
    return img_root, ann_root, lists, labels.shape


@contextlib.contextmanager
def patched(owner, attr, make):
    """Replace ``owner.attr`` by ``make(original)`` inside the block."""
    original = getattr(owner, attr)
    setattr(owner, attr, make(original))
    try:
        yield
    finally:
        setattr(owner, attr, original)


def wall_timer(walls):
    """``patched`` maker: append each call's wall seconds, the card's queue
    drained before and after, to ``walls``."""
    import torch

    def make(fn):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.time()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            walls.append(time.time() - t0)
            return out
        return timed
    return make


def span_timer(spans):
    """``patched`` maker: record a pair of CUDA events around each call on
    the current stream into ``spans``; ``spans_ms`` sums them."""
    import torch

    def make(fn):
        def timed(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            spans.append((start, end))
            return out
        return timed
    return make


def spans_ms(spans):
    import torch
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in spans)


def write_eval_inputs(root):
    """The eval path's inputs under ``root``: ``write_davis``'s dataset and
    the r50 backbone of CONFIG_R50 with seeded random weights, saved as a
    torchvision-layout ``.pth``. Returns ``write_davis``'s values and the
    checkpoint's path."""
    import runpy
    import torch
    from vfs_tpu_torch.models.backbones import ResNet
    data = write_davis(root)
    backbone_cfg = dict(runpy.run_path(CONFIG_R50)['model']['backbone'])
    backbone_cfg.pop('type')
    backbone = ResNet(**backbone_cfg)
    backbone.init_weights(torch.Generator().manual_seed(0))
    ckpt = os.path.join(root, 'r50.pth')
    torch.save(backbone.state_dict(), ckpt)
    return (*data, ckpt)


def eval_argv(root, img_root, ann_root, ann_file, ckpt, backend, out):
    """``python -m vfs_tpu_torch.tools.test``'s arguments for the eval path
    on ``write_eval_inputs``'s dataset."""
    return [CONFIG_R50, ckpt, '--eval', 'davis', '--out', out,
            '--options', f'test_cfg.backend={backend}',
            f'data.test.ann_file={ann_file}',
            f'data.test.data_prefix={img_root}',
            f'data.test.anno_prefix={ann_root}',
            f'data.test.data_root={root}']


def phase_eval(local_full):
    """Slice 2's path: ``python -m vfs_tpu_torch.tools.test`` on the r50
    config with ``backend=pallas``, run in-process. The counted run also
    times its stages with CUDA events around ``_extract_feats`` and
    ``propagate_video``. Returns the kernels line's entry of
    ``local_topk_attend``."""
    import vfs_tpu_torch.apis as apis
    from vfs_tpu_torch.models.trackers import vanilla_tracker
    from vfs_tpu_torch.ops import (local_topk_attend_cuda,
                                   local_topk_attend_reference, propagation)
    from vfs_tpu_torch.tools import test as tools_test

    os.makedirs(os.path.join(ROOT, 'build'), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, 'build')) as root:
        (img_root, ann_root, (list_all, list_one), shape,
         ckpt) = write_eval_inputs(root)

        def run(backend, ann_file, name):
            out = os.path.join(root, f'{name}.npz')
            jf = tools_test.main(eval_argv(root, img_root, ann_root,
                                           ann_file, ckpt, backend, out))
            with np.load(out) as saved:
                masks = [saved[f'arr_{i}'] for i in range(len(saved.files))]
            return jf, masks

        walls, extract_spans, scan_spans = [], [], []
        with patched(apis, 'single_process_test', wall_timer(walls)):
            run('pallas', list_all, 'cold')
            first_s = walls[-1]
            # the path, counted and timed per stage
            local_topk_attend_cuda.launches = 0
            with patched(vanilla_tracker.VanillaTracker, '_extract_feats',
                         span_timer(extract_spans)), \
                    patched(vanilla_tracker, 'propagate_video',
                            span_timer(scan_spans)):
                jf, masks = run('pallas', list_all, 'scan')
            launches = local_topk_attend_cuda.launches
            eval_s = walls[-1]
            extract_ms, scan_ms = spans_ms(extract_spans), spans_ms(scan_spans)
            _, masks_video = run('pallas_video', list_all, 'video')
            with patched(propagation, 'local_topk_attend',
                         lambda _: local_topk_attend_reference):
                _, masks_plain = run('pallas', list_one, 'plain')

        frames = sum(m.shape[0] for m in masks)
        steps = sum(m.shape[0] - 1 for m in masks)
        if launches < steps or steps < 2 * (shape[0] - 1):
            raise AssertionError(f'{launches} scan-kernel launches for '
                                 f'{steps} steps')
        for m in masks:
            if m.shape != shape or m.dtype != np.uint8 or m.max() > 2:
                raise AssertionError(f'bad masks {m.shape} {m.dtype}')
        agree_video = float(np.mean([(a == b).mean()
                                     for a, b in zip(masks, masks_video)]))
        agree_plain = float((masks[0] == masks_plain[0]).mean())
        if agree_video < 0.999 or agree_plain < 0.999:
            raise AssertionError(
                f'masks agree on {agree_video} (pallas_video) and '
                f'{agree_plain} (plain per-step) < 0.999')
        if not 0.0 <= jf['J&F-Mean'] <= 1.0:
            raise AssertionError(f"J&F {jf['J&F-Mean']} out of range")
    emit({'phase': 'eval', 'config': os.path.relpath(CONFIG_R50, ROOT),
          'backend': 'pallas', 'videos': len(masks), 'frames': frames,
          'first_call_s': first_s, 'eval_s': eval_s,
          'eval_fps': frames / eval_s,
          'extract_ms_per_frame': extract_ms / frames,
          'scan_ms_per_frame': scan_ms / steps,
          'mask_agree_pallas_video': agree_video,
          'mask_agree_plain_per_step': agree_plain,
          'kernel_launches': launches, 'steps': steps,
          **{k: float(v) for k, v in jf.items()}})
    return dict(**LOCAL_INFO, launches=launches,
                max_abs_err=local_full['max_abs_err'],
                src_mismatch=local_full['src_mismatch'],
                ms=local_full['kernel_ms_per_step'],
                plain_ms=local_full['plain_ms_per_step'],
                bound_ms=local_full['bound_ms_per_step'],
                bound_by=local_full['bound_by'], library_ms=None,
                library_note=NO_LIBRARY_CALL)


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 2
    import vfs_tpu_torch  # noqa: F401  (fails outside a checkout)
    dev = torch.device('cuda', 0)
    torch.cuda.set_device(dev)
    smi_line = phase_build()
    phase_small(dev)
    local_full = phase_full(dev, smi_line)
    kernels = phase_main(dev, smi_line)
    kernels.append(phase_eval(local_full))
    emit({'kernels': kernels})
    emit({'ok': True, 'device': {'platform': 'gpu',
                                 'kind': torch.cuda.get_device_name(0),
                                 'count': torch.cuda.device_count()}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
