"""The one general generator of the benchmark's inputs. A traffic file
(``traffic/<name>.json``) gives the parameters; its ``generator`` key
picks the shape of the inputs:

- ``davis_videos``: DAVIS-2017-layout videos written under a directory
  (JPEG frames, frame 0's palette-PNG annotation, a list file): a blocky
  textured background and ``objects`` shapes (discs and boxes) of
  distinct colours moving across it, each video from its own draws. Every seed writes
  the same frame counts (``lengths``) in the same order: the eval's
  first video is decoded before any computes, so its length is work
  that the order would move;
- ``train_ring``: a ring of ``ring`` distinct train batches made on the
  device, (B, 2, T, H, W, 3): fp32 frames normalised with the
  configuration's mean and std (``dtype`` float32), or uint8 staging
  frames with their (B, 2) original sizes (``dtype`` uint8), each a
  blocky texture of ``block``-pixel cells.

Only the seed varies the content: the shapes, sizes and counts are the
file's.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

import numpy as np
import torch

# threads that encode a video's JPEG frames in set-up
ENCODERS = 4
PALETTE = [0, 0, 0, 128, 0, 0, 0, 128, 0, 128, 128, 0, 0, 0, 128, 128, 0,
           128]


def seed_rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % 2**63, *stream])


def _colour(rng: np.random.Generator, k: int) -> np.ndarray:
    """Object ``k``'s colour: bright (200-255) in channel ``k % 3``, dark
    (0-99) in the others. No two of the first three objects, nor an
    object and the background (0-159 in every channel), look alike:
    where two objects share an appearance, which is which is a near tie
    of the scores, and two correct fp32 computations label it apart."""
    colour = rng.integers(0, 100, 3)
    colour[k % 3] = rng.integers(200, 256)
    return colour.astype(np.uint8)


def _video(rng: np.random.Generator, t_total: int, h: int, w: int,
           objects: int, block: int):
    """uint8 (T, H, W, 3) frames and the (H, W) uint8 labels of frame 0."""
    base = rng.integers(0, 160, (h // block + 1, w // block + 1, 3),
                        dtype=np.uint8)
    base = np.repeat(np.repeat(base, block, 0), block, 1)[:h, :w]
    shapes = []
    for k in range(objects):
        size = rng.uniform(0.08, 0.16) * h
        shapes.append(dict(
            disc=k % 2 == 0, size=size,
            y=rng.uniform(size, h - size), x=rng.uniform(size, w - size),
            vy=rng.uniform(-2.0, 2.0), vx=rng.uniform(-5.0, 5.0),
            colour=_colour(rng, k)))
    frames = np.empty((t_total, h, w, 3), np.uint8)
    labels = np.zeros((h, w), np.uint8)
    for t in range(t_total):
        frames[t] = base
        for k, s in enumerate(shapes):
            cy = np.clip(s['y'] + s['vy'] * t, s['size'], h - s['size'])
            cx = np.clip(s['x'] + s['vx'] * t, s['size'], w - s['size'])
            # the shape's bounding rows and columns; it lies inside them
            y0, y1 = int(cy - s['size']), int(np.ceil(cy + s['size'])) + 1
            x0, x1 = int(cx - s['size']), int(np.ceil(cx + s['size'])) + 1
            yy, xx = np.mgrid[max(y0, 0):min(y1, h), max(x0, 0):min(x1, w)]
            if s['disc']:
                inside = (yy - cy) ** 2 + (xx - cx) ** 2 < s['size'] ** 2
            else:
                inside = (np.abs(yy - cy) < s['size'] * 0.8) \
                    & (np.abs(xx - cx) < s['size'])
            rows, cols = slice(max(y0, 0), y1), slice(max(x0, 0), x1)
            frames[t, rows, cols][inside] = s['colour']
            if t == 0:
                labels[rows, cols][inside] = k + 1
    return frames, labels


def davis_videos(traffic: Dict, seed: int, root: str,
                 warmup: List[int] = ()) -> Dict:
    """Write the videos under ``root`` (module docstring), and after them
    videos of the ``warmup`` frame counts. Returns the DAVIS paths, the
    list files of the traffic's videos (``all``) and of the warm-up ones
    (``warmup``), and the traffic's frame counts in list order."""
    import cv2
    from PIL import Image
    h, w = traffic['height'], traffic['width']
    lengths = list(traffic['lengths'])
    img_root = os.path.join(root, 'JPEGImages', '480p')
    ann_root = os.path.join(root, 'Annotations', '480p')
    lines: List[str] = []
    counts: List[int] = []
    quality = [int(cv2.IMWRITE_JPEG_QUALITY), int(traffic['jpeg_quality'])]

    def write(path, frame):
        ok, buf = cv2.imencode('.jpg', frame[..., ::-1], quality)
        if not ok:
            raise IOError(f'cannot encode {path}')
        buf.tofile(path)

    for v, t_total in enumerate(lengths + list(warmup)):
        frames, first = _video(seed_rng(seed, 1, v), t_total, h, w,
                               traffic['objects'], traffic['block'])
        name = f'video{v:02d}'
        os.makedirs(os.path.join(img_root, name))
        os.makedirs(os.path.join(ann_root, name))
        # cv2's encoder releases the interpreter lock
        with ThreadPoolExecutor(ENCODERS) as pool:
            for f in [pool.submit(write, os.path.join(img_root, name,
                                                      f'{t:05}.jpg'),
                                  frames[t]) for t in range(t_total)]:
                f.result()
        ann = Image.fromarray(first)
        ann.putpalette(PALETTE)
        ann.save(os.path.join(ann_root, name, '00000.png'))
        lines.append(f'{name} {t_total} 0\n')
        counts.append(t_total)
    lists = {}
    n = len(lengths)
    for key, chosen in (('all', lines[:n]), ('warmup', lines[n:])):
        lists[key] = os.path.join(root, f'list_{key}.txt')
        with open(lists[key], 'w') as f:
            f.writelines(chosen)
    return dict(root=root, img_root=img_root, ann_root=ann_root,
                lists=lists, lengths=counts[:n])


def train_batch(traffic: Dict, seed: int, index: int, device,
                norm: Dict = None) -> Dict[str, torch.Tensor]:
    """Batch ``index`` of the ring, made on ``device`` from its own
    generator: ``imgs`` and, for uint8 staging frames, ``orig_hw``."""
    b, v, t = traffic['batch'], traffic['views'], traffic['frames']
    h, w, block = traffic['height'], traffic['width'], traffic['block']
    generator = torch.Generator(device=device)
    generator.manual_seed(int(seed) * 1009 + index)
    cells = torch.randint(0, 256, (b, v, t, -(-h // block), -(-w // block),
                                   3), generator=generator, device=device,
                          dtype=torch.uint8)
    imgs = cells.repeat_interleave(block, 3).repeat_interleave(block, 4)
    imgs = imgs[:, :, :, :h, :w].contiguous()
    if traffic['dtype'] == 'uint8':
        orig = torch.tensor(traffic['orig_hw'], dtype=torch.int64,
                            device=device)
        return dict(imgs=imgs, orig_hw=orig.expand(b, 2).contiguous())
    mean = torch.tensor(norm['mean'], dtype=torch.float32, device=device)
    std = torch.tensor(norm['std'], dtype=torch.float32, device=device)
    return dict(imgs=(imgs.to(torch.float32) - mean) / std)


def train_ring(traffic: Dict, seed: int, device,
               norm: Dict = None) -> List[Dict[str, torch.Tensor]]:
    return [train_batch(traffic, seed, i, device, norm)
            for i in range(traffic['ring'])]
