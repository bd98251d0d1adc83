"""Synthetic inputs of the analysis CLIs that the smoke run shares."""

from __future__ import annotations

import os

import numpy as np


def clip_format(root):
    """(extension, fourcc) of the clips ``write_k400`` writes: mp4v
    ``.mp4``, the JAX tool's (``make_fake_k400``), where this cv2 can open
    that writer (it needs FFmpeg), else MJPG ``.avi``, which OpenCV
    writes on its own."""
    import cv2
    probe = os.path.join(root, '.probe.mp4')
    writer = cv2.VideoWriter(probe, cv2.VideoWriter_fourcc(*'mp4v'), 25,
                             (32, 32))
    ok = writer.isOpened()
    writer.release()
    if os.path.exists(probe):
        os.unlink(probe)
    return ('mp4', 'mp4v') if ok else MJPG


MJPG = ('avi', 'MJPG')


def write_k400(root, n_clips, n_frames, hw, fmt=None):
    """A Kinetics-layout set under ``root``: ``n_clips`` clips of
    ``n_frames`` frames of ``hw``, a blocky textured background with a
    disc moving across it, each from its own seed, and the list file. The
    clips are in ``fmt``, an (extension, fourcc) pair, by default
    ``clip_format``'s. Every frame of every clip must read back through
    cv2. Returns the list file's path."""
    import cv2
    h, w = hw
    ext, fourcc = fmt or clip_format(root)
    lines = []
    yy, xx = np.mgrid[:h, :w]
    for v in range(n_clips):
        rng = np.random.RandomState(100 + v)
        base = rng.randint(0, 255, (h // 16 + 1, w // 16 + 1, 3))
        base = np.repeat(np.repeat(base, 16, 0), 16, 1)[:h, :w]
        colour = rng.randint(0, 255, 3)
        name = f'clip{v:03d}.{ext}'
        writer = cv2.VideoWriter(os.path.join(root, name),
                                 cv2.VideoWriter_fourcc(*fourcc), 25,
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
