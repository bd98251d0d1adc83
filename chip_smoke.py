#!/usr/bin/env python3
"""Run vfs_tpu_torch's main path on one CUDA card and hold every kernel
against its plain PyTorch version.

    python3 chip_smoke.py            # every phase, on one card

Phases, one JSON line each on stdout:

1. build: compile the package's CUDA source (``nvcc``, sm_90a);
   then the card's name and power limit as ``nvidia-smi`` gives them.
2. small: the kernel vs ``video_topk_affinity_reference`` over the CPU
   tests' small-shape matrix plus a duplicated-frame tie case.
3. full: the same at the r18 (C=256, radius 12) and r50 (C=1024, radius
   18) DAVIS-480p shapes (60x107 cells, T=24, P=20, top-10), with
   CUDA-event timings (median of 5 after a warm-up)
   at T=24 and T=48, and the FLOP bound.
4. main: DAVIS label-propagation eval, r18 model of
   configs/r18_nc_sgd_cos_100e_r2_1xNx8_k400.py at full width with seeded
   random weights, on a synthetic 48x480x854 two-object video, through
   ``build_model(...).forward_test``; the kernel's launch count must rise
   and the masks must agree with a run whose phase 1 is the plain version.
5. kernels: every kernel of the path with its launches and times.

The last line is ``{"ok": true, "device": {...}}``; any failure raises and
exits non-zero before it. Without a CUDA device the script exits 2.

Tolerances. The kernel sums each 256/1024-term dot product with fmaf in
channel order; the plain version uses a cuBLAS fp32 matrix product (TF32
off), which sums in another order. Scores therefore differ by ~1e-6
absolute (scores are cosines / 0.07, |s| <= 14.3): checked at rtol 1e-5,
atol 1e-5. Two candidates whose scores lie that close may swap places,
so sources must agree on >= 99.99% of entries (exactly on the tie case,
where the equal scores are bit-identical in both versions); masks of the
main path on >= 99.9% of pixels.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, 'configs', 'r18_nc_sgd_cos_100e_r2_1xNx8_k400.py')

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
    from vfs_tpu_torch.ops.video_affinity import circle_offsets
    _, dy, dx = circle_offsets(radius)
    ys, xs = np.arange(h)[:, None, None], np.arange(w)[None, :, None]
    ky, kx = ys + dy.numpy(), xs + dx.numpy()
    pairs = int(((ky >= 0) & (ky < h) & (kx >= 0) & (kx < w)).sum())
    live = sum(min(t, p + 1) for t in range(1, t_total))
    flops = 2.0 * c * pairs * live
    nbytes = 4.0 * t_total * h * w * c + 12.0 * (t_total - 1) * h * w * topk
    return flops, nbytes


def bound_ms(flops, nbytes, name):
    tflops, tbps = peaks(name)
    by_ops = flops / (tflops * 1e12) * 1e3
    by_bytes = nbytes / (tbps * 1e12) * 1e3
    return max(by_ops, by_bytes), ('operations' if by_ops >= by_bytes
                                   else 'bytes')


def compare(kernel, plain, exact_src, what):
    """Kernel vs plain outputs (rows t >= 1). Returns (max_abs_err, number
    of differing sources, their share) and raises past the tolerances."""
    import torch
    ks, ki = kernel[0][1:], kernel[1][1:]
    ps, pi = plain[0][1:], plain[1][1:]
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


def phase_build():
    from vfs_tpu_torch.ops import _build
    t0 = time.time()
    lib = _build.build(KERNEL_INFO['name'])
    secs = time.time() - t0
    log = lib.with_suffix('.log')
    ptxas = [ln.strip() for ln in log.read_text().splitlines()
             if 'registers' in ln or 'spill' in ln]
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
    return compare(out_k, out_p, exact_src, what)


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
    emit({'phase': 'small', 'columns': ['T', 'h', 'w', 'neighbor_range', 'P',
                                        'topk', 'max_abs_err',
                                        'src_mismatch'],
          'cases': results,
          'tie_case': {'max_abs_err': err, 'src_mismatch': mismatch}})


def phase_full(dev, smi_name):
    """Correctness at T=24; times at T=24 and T=48. Frames 24..47 all see
    the full bank (P+1 frames), so (time(48) - time(24)) / 24 is the
    steady-state time per frame."""
    import torch
    from vfs_tpu_torch.device import exact_fp32
    from vfs_tpu_torch.ops import (l2_normalize, video_topk_affinity_cuda,
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
    emit({'phase': 'full', **out})


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
        err, mismatch, _ = compare(out_k, out_p, False,
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
    phase_full(dev, smi_line)
    emit({'kernels': phase_main(dev, smi_line)})
    emit({'ok': True, 'device': {'platform': 'gpu',
                                 'kind': torch.cuda.get_device_name(0),
                                 'count': torch.cuda.device_count()}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
