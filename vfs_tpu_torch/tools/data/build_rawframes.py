"""Extract RGB rawframes from a tree of videos (counterpart of
``tools/data/build_rawframes.py``; reference:
tools/data/build_rawframes.py).

    python -m vfs_tpu_torch.tools.data.build_rawframes SRC_DIR OUT_DIR \\
        [--level 1|2] [--ext mp4] [--num-worker 8] [--new-short N |
        --new-width W --new-height H] [--filename-tmpl img_{:05d}.jpg]
        [--start-index 1] [--resume]

Each video under SRC_DIR (``--level 2``: one class directory deep) becomes
a directory of JPEGs under OUT_DIR with the same relative path. Frames
decode through the native FFmpeg decoder (``datasets.native_loader``),
resized there with swscale's bilinear filter, or with cv2 where the
decoder is unavailable; a pool of spawned processes takes the videos. Optical flow is
not extracted. Exits 1 if any video gave no frames.
"""

from __future__ import annotations

import argparse
import glob
import os
import os.path as osp
import sys
import multiprocessing
from typing import Optional, Sequence

import numpy as np


def parse_args(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description='Extract RGB rawframes')
    parser.add_argument('src_dir', help='video source directory')
    parser.add_argument('out_dir', help='rawframes output directory')
    parser.add_argument('--level', type=int, default=2, choices=[1, 2])
    parser.add_argument('--ext', default='mp4',
                        help='video file extension (mp4/avi/webm/...)')
    parser.add_argument('--num-worker', type=int, default=8)
    parser.add_argument('--new-width', type=int, default=0)
    parser.add_argument('--new-height', type=int, default=0)
    parser.add_argument('--new-short', type=int, default=0,
                        help='resize so the short side is N (0 = keep)')
    parser.add_argument('--filename-tmpl', default='img_{:05d}.jpg')
    parser.add_argument('--start-index', type=int, default=1,
                        help='index of the first frame file')
    parser.add_argument('--resume', action='store_true',
                        help='skip videos whose output dir is non-empty')
    return parser.parse_args(argv)


def out_size(h, w, new_w, new_h, new_short):
    """(height, width) of the written frames."""
    if new_short > 0:
        if h <= w:
            return new_short, max(1, int(round(w * new_short / h)))
        return max(1, int(round(h * new_short / w))), new_short
    if new_w > 0 and new_h > 0:
        return new_h, new_w
    return h, w


def decode_all(path, new_w, new_h, new_short) -> Optional[np.ndarray]:
    """Every frame of one video as (T, H, W, 3) uint8 RGB (the native
    decoder, else cv2); None if none decodes."""
    from ...datasets.native_loader import decode_video_indices, probe_video
    probed = probe_video(path)
    if probed is not None and probed[0] > 0:
        nf, h, w, _ = probed
        frames = decode_video_indices(
            path, np.arange(nf), out_size(h, w, new_w, new_h, new_short))
        if frames is not None:
            return frames
    import cv2
    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        h, w = frame.shape[:2]
        oh, ow = out_size(h, w, new_w, new_h, new_short)
        if (oh, ow) != (h, w):
            frame = cv2.resize(frame, (ow, oh),
                               interpolation=cv2.INTER_LINEAR)
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    cap.release()
    return np.stack(frames) if frames else None


def extract_one(task):
    """Write one video's frames; returns (relative path, frames written),
    -1 for a video skipped by ``resume``."""
    full_path, rel_path, opts = task
    out_dir = osp.join(opts['out_dir'], osp.splitext(rel_path)[0])
    os.makedirs(out_dir, exist_ok=True)
    if opts['resume'] and os.listdir(out_dir):
        return rel_path, -1
    frames = decode_all(full_path, opts['new_width'], opts['new_height'],
                        opts['new_short'])
    if frames is None:
        return rel_path, 0
    import cv2
    for i, frame in enumerate(frames):
        name = opts['filename_tmpl'].format(i + opts['start_index'])
        cv2.imwrite(osp.join(out_dir, name),
                    cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
    return rel_path, len(frames)


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Returns the number of videos that failed."""
    args = parse_args(argv)
    pattern = osp.join(args.src_dir, *(['*'] * (args.level - 1)),
                       f'*.{args.ext}')
    videos = sorted(glob.glob(pattern))
    print(f'{len(videos)} videos under {args.src_dir}')
    os.makedirs(args.out_dir, exist_ok=True)
    opts = dict(out_dir=args.out_dir, new_width=args.new_width,
                new_height=args.new_height, new_short=args.new_short,
                filename_tmpl=args.filename_tmpl,
                start_index=args.start_index, resume=args.resume)
    tasks = [(v, osp.relpath(v, args.src_dir), opts) for v in videos]
    failed = 0
    # spawned, not forked: the caller may hold threads (a pytest or torch
    # process) whose locks a forked child would inherit taken
    with multiprocessing.get_context('spawn').Pool(args.num_worker) as pool:
        for i, (rel, n) in enumerate(pool.imap_unordered(extract_one, tasks)):
            if n == 0:
                failed += 1
                print(f'FAILED {rel}')
            elif (i + 1) % 100 == 0:
                print(f'[{i + 1}/{len(videos)}] {rel}: {n} frames')
    print(f'done; {failed} failures')
    return failed


if __name__ == '__main__':
    sys.exit(1 if main() else 0)
