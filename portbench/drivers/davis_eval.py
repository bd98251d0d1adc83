"""The DAVIS label-propagation eval as ``tools.test`` runs it: one process,
``apis.single_process_test`` with its prefetch thread over a
``DavisDataset`` of the traffic's videos, a ``VanillaTracker`` rebuilt
from the configuration's backbone and ``test_cfg``.

Set-up writes the videos (``harness.traffic.davis_videos``) under
``$TMPDIR``, makes the seeded weights on the card and runs the eval once
over short videos that give the backbone every chunk size the window
meets (``warmup_lengths``). The window runs the whole video list, back to back, as
often as it takes to fill ``--seconds``: ``eval_fps`` is all its frames
over all its time. A traced run profiles the same window, with spans
around the tracker's extraction and propagation.

``correct``: one video of the window's first pass, drawn from the seed,
is decoded, normalised, extracted, propagated and decoded again by the
plain reference (``reference.resnet``, ``reference.propagation``, fp32,
TF32 off) once the program is freed. What the window produced for that
video is kept by wrappers (``capture``): three frames of each bank from
the tracker's ``_extract_feats``, and each block's top-k scores from the
windowed top-k (row 1, ``ops.propagation.video_topk_affinity``).
``feature_gap``: the largest relative L2 gap, over the blocks, between
the program's features and the reference's. ``topk_score_gap``: the
largest gap, over the blocks, the frames 1..T-1 and every query, between
the program's and the reference's top-k scores, each query's sorted, in
cosine similarity (the scores times the temperature): a near tie swaps
two candidates but not the values. ``mask_mismatch``: the largest share,
over the blocks, of the pixels of frames 1..T-1 whose label differs from
the program's. Masks are argmax decisions: a near tie of the top-k
scores, which two correct fp32 computations break apart, flips a feature
cell's label, and propagation carries it on, so this number catches
altered answers, not a loss of precision; the features and the scores
catch that.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch

from portbench.harness import flops, traffic as traffic_gen, weights
from portbench.harness.runner import Check, Outcome
from portbench.harness.trace import span, spanned, traced
from portbench.reference import precision, propagation, resnet


def tuples(x):
    """JSON's lists as the tuples that the pipeline's configs hold."""
    if isinstance(x, dict):
        return {k: tuples(v) for k, v in x.items()}
    if isinstance(x, list):
        return tuple(tuples(v) for v in x)
    return x


def warmup_lengths(lengths, test_cfg: Dict) -> List[int]:
    """Frame counts whose extraction meets every chunk size that
    ``lengths`` give (``batch_step`` frames a chunk, and each video's
    last chunk)."""
    step = test_cfg.get('batch_step', 20)
    return sorted({t % step or step for t in lengths} | {min(step,
                                                             max(lengths))})


def dataset_cfg(cfg: Dict, data: Dict, which: str) -> Dict:
    return dict(type=cfg['dataset'], ann_file=data['lists'][which],
                data_prefix=data['img_root'], anno_prefix=data['ann_root'],
                data_root=data['root'],
                pipeline=[tuples(t) for t in cfg['val_pipeline']],
                test_mode=True)


def reference_backbone(cfg: Dict, device) -> resnet.ResNet:
    bb = cfg['model']['backbone']
    tc = cfg['test_cfg']
    return resnet.ResNet(bb['depth'], strides=tc['strides'],
                         out_indices=tc['out_indices']).to(device)


def read_frames(data: Dict, name: str, t_total: int,
                norm: Dict) -> np.ndarray:
    """A video's frames as the eval pipeline gives them: decoded by cv2,
    RGB, ``(x - mean) / std`` in fp32."""
    import cv2
    mean = np.asarray(norm['mean'], np.float32)
    std = np.asarray(norm['std'], np.float32)
    frames = []
    for t in range(t_total):
        img = cv2.imread(os.path.join(data['img_root'], name, f'{t:05}.jpg'),
                         cv2.IMREAD_COLOR)
        frames.append(cv2.cvtColor(img, cv2.COLOR_BGR2RGB))
    return (np.stack(frames).astype(np.float32) - mean) / std


def checked_frames(t_total: int) -> List[int]:
    """The frames whose features the check compares: the first, the
    middle and the last."""
    return sorted({0, t_total // 2, t_total - 1})


def reference(cfg: Dict, data: Dict, video: int, seed: int, device,
              mode: str = 'fp32', row1_mode: str = None):
    """The reference's (blocks, T, H, W) uint8 masks of ``video``, each
    block's features at ``checked_frames`` and each block's (T, h, w,
    topk) scores; the extraction computes in ``mode``, the scores in
    ``row1_mode`` (``mode`` if None)."""
    from PIL import Image
    tc = cfg['test_cfg']
    name = f'video{video:02d}'
    t_total = data['lengths'][video]
    frames = read_frames(data, name, t_total, cfg['img_norm_cfg'])
    ann = np.asarray(Image.open(os.path.join(data['ann_root'], name,
                                             '00000.png')))
    model = reference_backbone(cfg, 'meta')
    state = weights.seeded_state(model, cfg['weights'], seed, device)
    model = reference_backbone(cfg, device).eval()
    model.load_state_dict(state)
    del state
    step = tc.get('batch_step', 20)
    all_blocks = tc.get('all_blocks', False)
    banks: List[List[torch.Tensor]] = []
    with torch.no_grad(), precision.matmul_precision(mode):
        for i in range(0, t_total, step):
            x = torch.from_numpy(frames[i:i + step]).to(device)
            outs = model(x, blocks=True) if all_blocks else (model(x),)
            for j, o in enumerate(outs):
                if len(banks) <= j:
                    banks.append([])
                banks[j].append(o.contiguous())
        del model
    out, kept, scores = [], [], []
    with torch.no_grad(), precision.matmul_precision(row1_mode or mode):
        for parts in banks:
            feats = torch.cat(parts)
            parts.clear()
            kept.append(feats[checked_frames(t_total)].clone())
            first, n_cls = propagation.first_labels(ann, feats.shape[1:3])
            labels, best = propagation.propagate(
                feats, first.to(device), tc['precede_frames'], tc['topk'],
                tc['temperature'], tc['neighbor_range'])
            scores.append(best)
            del feats
            masks = propagation.decode(labels, ann.shape, n_cls)
            masks[0] = torch.from_numpy(ann.astype(np.uint8)).to(device)
            out.append(masks.cpu().numpy())
    return np.stack(out), kept, scores


def feature_gap(program, ref) -> float:
    """The largest relative L2 gap, over the blocks, of the checked
    frames' features; 1 where they are missing or differ in shape."""
    if program is None or len(program) != len(ref):
        return 1.0
    gaps = []
    for p, r in zip(program, ref):
        if p.shape != r.shape:
            return 1.0
        gaps.append(float(torch.linalg.vector_norm((p.to(r.device) - r)
                                                   .double())
                          / torch.linalg.vector_norm(r.double())))
    return max(gaps)


@contextlib.contextmanager
def capture(model, video: int):
    """While open, keep what the ``video``-th video that ``model`` runs
    (the sampled video of the window's first pass) produces: each bank's
    ``checked_frames`` from ``model._extract_feats`` (``'banks'``) and each
    block's top-k scores from the program's windowed top-k
    (``'scores'``); yields the dict that receives them."""
    from vfs_tpu_torch.ops import propagation as program_propagation
    kept: Dict = dict(scores=[])
    extract = model._extract_feats
    topk = program_propagation.video_topk_affinity
    calls = [0]

    def capturing(*args, **kwargs):
        banks = extract(*args, **kwargs)
        if calls[0] == video:
            idx = checked_frames(banks[0].shape[0])
            kept['banks'] = [b[idx].clone() for b in banks]
        calls[0] += 1
        return banks

    def scoring(*args, **kwargs):
        scores, src = topk(*args, **kwargs)
        if calls[0] == video + 1:
            kept['scores'].append(scores.clone())
        return scores, src
    model._extract_feats = capturing
    program_propagation.video_topk_affinity = scoring
    try:
        yield kept
    finally:
        program_propagation.video_topk_affinity = topk


def score_diffs(program, ref):
    """Each block's gaps of the sorted top-k scores of frames 1..T-1, or
    None where the blocks are missing or differ in shape."""
    if len(program) != len(ref) or any(p.shape != r.shape
                                       for p, r in zip(program, ref)):
        return None
    out = []
    for p, r in zip(program, ref):
        p = torch.sort(p[1:].to(r.device), dim=-1, descending=True).values
        r = torch.sort(r[1:], dim=-1, descending=True).values
        out.append(torch.where(p == r, 0.0, (p - r).abs()))
    return out


def score_gap(program, ref, temperature: float) -> float:
    """The largest gap, over the blocks, frames 1..T-1 and queries, of the
    sorted top-k scores, times ``temperature``; 1 where they are missing
    or differ in shape."""
    diffs = score_diffs(program, ref)
    if diffs is None:
        return 1.0
    return max(float(d.max()) for d in diffs) * temperature


def compare(masks, captured: Dict, ref, limits: Dict,
            temperature: float) -> List[Check]:
    """The checks of the program's ``masks`` and ``captured`` features and
    scores against the reference's (masks, features, scores) ``ref``."""
    ref_masks, ref_feats, ref_scores = ref
    return [Check('feature_gap', feature_gap(captured.get('banks'),
                                             ref_feats),
                  limits['feature_gap']),
            Check('topk_score_gap', score_gap(captured['scores'], ref_scores,
                                              temperature),
                  limits['topk_score_gap']),
            Check('mask_mismatch', mismatch(masks, ref_masks)
                  if masks is not None else 1.0, limits['mask_mismatch'])]


def mismatch(program: np.ndarray, ref: np.ndarray) -> float:
    """The largest share, over the blocks, of frames 1..T-1's pixels whose
    label differs; 1 where the shapes differ."""
    if program.shape != ref.shape:
        return 1.0
    return float(max((p[1:] != r[1:]).mean() for p, r in zip(program, ref)))


def detail(program: np.ndarray, ref: np.ndarray) -> Dict:
    """Each block's share of differing pixels over frames 1..T-1, and
    each frame's largest share over the blocks."""
    if program.shape != ref.shape:
        return {}
    diff = program[:, 1:] != ref[:, 1:]
    return dict(blocks=[float(d.mean()) for d in diff],
                frames=[float(x) for x in diff.mean(axis=(2, 3)).max(0)])


def feature_hw(cfg: Dict, traffic: Dict):
    """(h, w, C) of the eval features at the traffic's frame size, and the
    backbone's FLOPs a frame."""
    model = reference_backbone(cfg, 'meta')
    x = torch.zeros(1, traffic['height'], traffic['width'], 3,
                    device='meta')
    with torch.no_grad():
        o = model(x)
    frame_flops = flops.forward_flops(model, (1, traffic['height'],
                                              traffic['width'], 3))
    return o.shape[1], o.shape[2], o.shape[3], frame_flops


def build_tracker(cfg: Dict, seed: int, device):
    """The ``VanillaTracker`` that ``tools.test`` builds from the
    configuration, with the seeded weights, on ``device``."""
    from vfs_tpu_torch.models import build_model
    model = build_model(
        dict(type='VanillaTracker', backbone=dict(cfg['model']['backbone'])),
        test_cfg=tuples(cfg['test_cfg']))
    model.backbone.load_state_dict(weights.seeded_state(
        reference_backbone(cfg, 'meta'), cfg['weights'], seed, device))
    return model.to(device)


def run(ctx) -> Outcome:
    from vfs_tpu_torch.apis import single_process_test
    from vfs_tpu_torch.datasets import build_dataset

    cfg, tr, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    cuda = torch.device(dev).type == 'cuda'
    work = tempfile.mkdtemp(prefix='portbench_davis_')
    parts = dict(imports=time.perf_counter() - ctx.t_start)
    try:
        data = traffic_gen.davis_videos(
            tr, ctx.seed, work, warmup_lengths(tr['lengths'],
                                               cfg['test_cfg']))
        parts['inputs'] = time.perf_counter() - ctx.t_start
        dataset = build_dataset(dataset_cfg(cfg, data, 'all'),
                                dict(test_mode=True))
        warm = build_dataset(dataset_cfg(cfg, data, 'warmup'),
                             dict(test_mode=True))
        model = build_tracker(cfg, ctx.seed, dev)
        if ctx.tamper is not None:
            ctx.tamper(model)
        parts['model'] = time.perf_counter() - ctx.t_start
        single_process_test(model, warm, device=dev)
        sample = int(traffic_gen.seed_rng(ctx.seed, 2).integers(
            len(data['lengths'])))
        if ctx.trace:
            model._extract_feats = spanned('extract', model._extract_feats)
            model._propagate_decode = spanned('propagate',
                                              model._propagate_decode)
        if cuda:
            torch.cuda.synchronize()

        frames, videos, kept, bad, passes = 0, 0, None, 0, 0
        recorded: Dict = {}
        t0 = time.perf_counter()
        setup_s = t0 - ctx.t_start
        trace_ctx = traced(dev, recorded) if ctx.trace \
            else contextlib.nullcontext()
        with capture(model, sample) as captured, trace_ctx:
            while passes == 0 or time.perf_counter() - t0 < ctx.seconds:
                with span('pass'):
                    results = single_process_test(model, dataset, device=dev)
                passes += 1
                for i, r in enumerate(results):
                    r = np.asarray(r)
                    bad += int(r.ndim != 4 or r.shape[1]
                               != data['lengths'][i] or r.dtype != np.uint8)
                    if passes == 1 and i == sample:
                        kept = r
                frames += sum(data['lengths'])
                videos += len(results)
                del results
            if cuda:
                torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        del model, dataset, warm
        if cuda:
            torch.cuda.empty_cache()
        h, w, c, frame_flops = feature_hw(cfg, tr)
        tc = cfg['test_cfg']
        blocks = kept.shape[0] if kept is not None else 0
        counts = dict(frames=frames, frame_flops=frame_flops,
                      row1=[flops.row1_work(
                          t, h, w, c, float(tc['neighbor_range'] // 2),
                          tc['topk'], tc['precede_frames'])
                          for t in data['lengths'] * passes
                          for _ in range(blocks)])
        t_check = time.perf_counter()
        checks = compare(kept, captured, reference(cfg, data, sample,
                                                   ctx.seed, dev),
                         cfg['limits'], tc['temperature'])
        check_s = time.perf_counter() - t_check
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return Outcome(setup_s, dict(eval_fps=frames / window_s), videos, bad,
                   peak, checks, counts, recorded.get('trace'),
                   dict(window={'seconds': window_s, 'passes': passes,
                                'sampled_video': sample,
                                'check_s': check_s},
                        setup_parts=parts))


def readings(cell, seed: int, device, what: str):
    """The compared numbers of one seed on the video a run would sample,
    without a window, the mask detail (``detail``) and each block's
    largest and root-mean-square score gap: ``'program'`` (the program's eval of that video),
    ``'control'`` (the reference in TF32 in the program's place),
    ``'control_row1'`` (the same with only the scores in TF32, the
    extraction in fp32) or ``'swapped_labels'`` (the program's masks with
    objects 1 and 2 swapped: an answer altered where it is produced)."""
    from vfs_tpu_torch.apis import single_process_test
    from vfs_tpu_torch.datasets import build_dataset

    cfg, tr = cell.config, cell.traffic
    work = tempfile.mkdtemp(prefix='portbench_davis_')
    try:
        data = traffic_gen.davis_videos(tr, seed, work)
        sample = int(traffic_gen.seed_rng(seed, 2).integers(
            len(data['lengths'])))
        if what in ('program', 'swapped_labels'):
            one = os.path.join(work, 'list_sample.txt')
            with open(data['lists']['all']) as f:
                lines = f.readlines()
            with open(one, 'w') as f:
                f.write(lines[sample])
            data['lists']['sample'] = one
            model = build_tracker(cfg, seed, device)
            with capture(model, 0) as captured:
                masks = np.asarray(single_process_test(
                    model, build_dataset(dataset_cfg(cfg, data, 'sample'),
                                         dict(test_mode=True)),
                    device=device)[0])
            del model
            if what == 'swapped_labels':
                later = masks[:, 1:]
                later[:] = np.choose(later, [0, 2, 1] + list(range(
                    3, int(later.max()) + 1)))
        elif what in ('control', 'control_row1'):
            masks, feats, scores = reference(
                cfg, data, sample, seed, device,
                'tf32' if what == 'control' else 'fp32', 'tf32')
            captured = dict(banks=feats, scores=scores)
        else:
            raise KeyError(what)
        ref = reference(cfg, data, sample, seed, device)
        tau = cfg['test_cfg']['temperature']
        return (compare(masks, captured, ref, cfg['limits'], tau),
                dict(detail(masks, ref[0]), score_gaps=[
                    [float(d.max()) * tau, float(d.square().mean().sqrt())
                     * tau] for d in score_diffs(captured['scores'],
                                                 ref[2]) or []]))
    finally:
        shutil.rmtree(work, ignore_errors=True)
