"""Synthetic inputs of the analysis CLIs that the smoke run shares."""

from __future__ import annotations

import os

import numpy as np


def write_k400(root, n_clips, n_frames, hw):
    """A Kinetics-layout set under ``root``: ``n_clips`` MJPG ``.avi``
    clips (OpenCV writes MJPG without FFmpeg) of ``n_frames`` frames of
    ``hw``, a blocky textured background with a disc moving across it,
    each from its own seed, and the list file. Every frame of every clip
    must read back through cv2. Returns the list file's path."""
    import cv2
    h, w = hw
    lines = []
    yy, xx = np.mgrid[:h, :w]
    for v in range(n_clips):
        rng = np.random.RandomState(100 + v)
        base = rng.randint(0, 255, (h // 16 + 1, w // 16 + 1, 3))
        base = np.repeat(np.repeat(base, 16, 0), 16, 1)[:h, :w]
        colour = rng.randint(0, 255, 3)
        name = f'clip{v:03d}.avi'
        writer = cv2.VideoWriter(os.path.join(root, name),
                                 cv2.VideoWriter_fourcc(*'MJPG'), 25,
                                 (w, h))
        for t in range(n_frames):
            img = base.copy()
            cy, cx = 60 + 6 * t, 40 + 15 * t
            img[(yy - cy)**2 + (xx - cx)**2 < 45**2] = colour
            writer.write(img.astype(np.uint8))
        writer.release()
        cap = cv2.VideoCapture(os.path.join(root, name))
        read = 0
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            read += frame.shape == (h, w, 3)
        cap.release()
        if read != n_frames:
            raise AssertionError(f'{name}: cv2 read back {read} of '
                                 f'{n_frames} frames')
        lines.append(f'{name} {v % 400}\n')
    ann = os.path.join(root, 'k400_train_list.txt')
    with open(ann, 'w') as f:
        f.writelines(lines)
    return ann
