"""Synthetic OTB-layout sequences for the tracking benches and the smoke
run (the fixture of ``tools/analysis/bench_track.py``'s ``make_fixture``,
which ``bench.py`` also tracks)."""

from __future__ import annotations

import os

import numpy as np


def make_otb_fixture(root, n_seqs, n_frames, hw, seed=7):
    """OTB-layout moving-square sequences under ``root``
    (``Seq{s}/img/%04d.jpg`` and ``Seq{s}/groundtruth_rect.txt``); box
    size and motion scale with the frame, so the crop geometry (context
    margin, search region) matches real OTB magnitudes."""
    import cv2
    h, w = hw
    rng = np.random.RandomState(seed)
    side = max(h // 6, 24)
    for s in range(n_seqs):
        seq = os.path.join(root, f'Seq{s}', 'img')
        os.makedirs(seq, exist_ok=True)
        base = rng.randint(0, 60, (h, w, 3), np.uint8)
        color = rng.randint(140, 255, 3).tolist()
        x0, y0 = rng.randint(10, w // 3), rng.randint(10, h // 3)
        dx, dy = rng.randint(1, 4), rng.randint(1, 3)
        boxes = []
        for t in range(n_frames):
            img = base.copy()
            x = min(x0 + dx * t, w - side - 1)
            y = min(y0 + dy * t, h - side - 1)
            img[y:y + side, x:x + side] = color
            cv2.imwrite(os.path.join(seq, f'{t + 1:04}.jpg'),
                        img[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, 95])
            boxes.append([x + 1, y + 1, side, side])
        np.savetxt(os.path.join(root, f'Seq{s}', 'groundtruth_rect.txt'),
                   np.array(boxes), fmt='%d', delimiter=',')
