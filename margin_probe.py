#!/usr/bin/env python3
"""How many keys row 1's tensor-core path re-scores exactly, on the r50
all-blocks eval's own features.

    python3 margin_probe.py [--seed N] [--video V] [--cap N] [--out F.json]

Writes the ``davis_r50_all_blocks`` cell's videos for ``--seed``
(``portbench.harness.traffic.davis_videos``), builds the cell's tracker
with its seeded weights, extracts video ``V``'s six layer3 banks with the
port's own extraction (``VanillaTracker._extract_feats``) and normalises
them as propagation does. Then, for every query of frames 1..T-1 of each
bank, it scores the query's whole window (frame 0 and the P frames
before it, twice for frame 0 while t <= P, the circle, the map) in fp32
with TF32 off, takes the k-th score, and counts the keys within w of it
for windows w: 0 (the exact tie group), the margin m the kernel uses
(``window_geometry.prescore_margin`` times the bank's largest squared
norm: split 3xTF32 and 1xTF32), and the fmaf chain's own bound (C 2^-24
inv_tau) times 1, 1.25, 1.5 and 2. A pre-score lies within m of its
exact score, so a query whose count passes 32 is one whose list the
kernel cannot settle (its overflow pass takes it).

Prints one JSON line a bank and window: the median count, the shares of
queries over 32 (the list), over 48 ... 512 and over ``--cap``, p99 and
max, the shares of 8 x 32 tiles and 1 x 32 rows with a query over 32 (and
of rows over 48 ... 128), and the keys counted over the window's keys.
Needs one card; prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.abspath(__file__))
CELL = 'davis_r50_all_blocks'
KMAX = 32


def card_line() -> str:
    try:
        return subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return 'nvidia-smi unavailable'


def window_counts(feats, radius, inv_tau, topk, precede, windows):
    """For each query of frames 1..T-1: the number of keys (frame 0 twice
    while t <= P) whose fp32 score is at or above the query's k-th score
    less w, for each w of ``windows``; (len(windows), T-1, h, w) int64,
    and the window's valid keys a frame (T-1,) int64."""
    import torch
    from vfs_tpu_torch.ops.video_affinity import bank_frame, circle_offsets
    t_total, h, w, c = feats.shape
    dev = feats.device
    hw = h * w
    _, dy, dx = circle_offsets(radius, dev)
    ky = torch.arange(h, device=dev).view(h, 1, 1) + dy
    kx = torch.arange(w, device=dev).view(1, w, 1) + dx
    inb = ((ky >= 0) & (ky < h) & (kx >= 0) & (kx < w)).reshape(hw, -1)
    key_pos = (ky.clamp(0, h - 1) * w + kx.clamp(0, w - 1)).reshape(hw, -1)
    neg = torch.tensor(float('-inf'), device=dev)
    counts = torch.zeros((len(windows), t_total - 1, hw), dtype=torch.int64,
                         device=dev)
    keys = torch.zeros(t_total - 1, dtype=torch.int64)
    for t in range(1, t_total):
        q = feats[t].reshape(hw, c)
        cand = []
        for j in range(precede + 1):
            f = bank_frame(t, j, precede)
            if f is None:
                continue
            s = (q @ feats[f].reshape(hw, c).T) * inv_tau
            cand.append(torch.where(inb, s.gather(1, key_pos), neg))
        cand = torch.cat(cand, 1)
        keys[t - 1] = int(torch.isfinite(cand).sum())
        theta = torch.topk(cand, topk, dim=1).values[:, -1:]
        for i, m in enumerate(windows):
            counts[i, t - 1] = (cand >= theta - m).sum(1)
        del cand
    return counts.view(len(windows), t_total - 1, h, w), keys


def pad_rows(over):
    """Whether each 1 x 32 row of the tiles holds a True."""
    import torch
    t1, h, w = over.shape
    tw = -(-w // 32) * 32
    pad = torch.zeros((t1, h, tw), dtype=torch.bool, device=over.device)
    pad[:, :, :w] = over
    return pad.view(t1, h, tw // 32, 32).any(3)


def summary(n, keys, cap):
    """The distribution of one bank's counts ``n`` (T-1, h, w)."""
    import torch
    t1, h, w = n.shape
    flat = n.reshape(-1).double()
    over = n > KMAX
    th, tw = -(-h // 8) * 8, -(-w // 32) * 32
    pad = torch.zeros((t1, th, tw), dtype=torch.bool, device=n.device)
    pad[:, :h, :w] = over
    tiles = pad.view(t1, th // 8, 8, tw // 32, 32).any(4).any(2)
    rows = pad.view(t1, th, tw // 32, 32).any(3)[:, :h]
    return dict(median=float(flat.median()),
                over_32=float(over.double().mean()),
                over=[float((n > x).double().mean())
                      for x in (48, 64, 128, 256, 512)],
                rows_over=[float(pad_rows(n > x).double().mean())
                           for x in (48, 64, 128)],
                over_cap=float((n > cap).double().mean()),
                p99=float(torch.quantile(flat[:2 ** 24], 0.99)),
                max=int(n.max()),
                tiles_over_32=float(tiles.double().mean()),
                rows_over_32=float(rows.double().mean()),
                rescored_share=float(flat.sum()) / float(keys.sum()))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--seed', type=int, default=3200000013)
    parser.add_argument('--video', type=int, default=0)
    parser.add_argument('--cap', type=int, default=768)
    parser.add_argument('--out', default=None)
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print('margin_probe.py needs a CUDA card', file=sys.stderr)
        return 1
    from portbench.drivers import davis_eval
    from portbench.harness import spec, traffic as traffic_gen
    from vfs_tpu_torch.ops.affinity import l2_normalize
    from vfs_tpu_torch.ops.window_geometry import prescore_margin
    print(json.dumps(dict(card=card_line(),
                          device=torch.cuda.get_device_name(0))),
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = spec.find_cell(spec.load_json(spec.bench_file()), CELL)
    cfg, tr = cell.config, cell.traffic
    tc = cfg['test_cfg']
    work = tempfile.mkdtemp(prefix='margin_probe_')
    rows = []
    try:
        data = traffic_gen.davis_videos(tr, args.seed, work)
        name = f'video{args.video:02d}'
        t_total = data['lengths'][args.video]
        frames = davis_eval.read_frames(data, name, t_total,
                                        cfg['img_norm_cfg'])
        model = davis_eval.build_tracker(cfg, args.seed, 'cuda')
        banks = model._extract_feats(torch.from_numpy(frames).cuda(),
                                     int(tc.get('batch_step', 20)))
        del model
        inv_tau = float(torch.tensor(1.0 / tc['temperature'],
                                     dtype=torch.float32))
        radius = float(tc['neighbor_range'] // 2)
        for b, bank in enumerate(banks):
            feats = l2_normalize(bank, dim=-1).contiguous()
            c = feats.shape[-1]
            n2 = float(feats.double().pow(2).sum(-1).max())
            margins = dict(exact=0.0)
            for splits in (3, 1):
                coef, absolute = prescore_margin(c, inv_tau, splits)
                margins[f'{splits}xtf32'] = coef * n2 + absolute
            margins['chain'] = c * 2.0 ** -24 * inv_tau * n2
            for x in (1.25, 1.5, 2.0):
                margins[f'chain_x{x}'] = x * margins['chain']
            counts, keys = window_counts(feats, radius, inv_tau, tc['topk'],
                                         tc['precede_frames'],
                                         list(margins.values()))
            for i, (label, m) in enumerate(margins.items()):
                row = dict(bank=b, margin=label, window=m, n2=n2,
                           t=t_total, hw=list(feats.shape[1:3]),
                           **summary(counts[i], keys, args.cap))
                rows.append(row)
                print(json.dumps(row), flush=True)
            del feats, counts
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, 'w') as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == '__main__':
    sys.exit(main())
