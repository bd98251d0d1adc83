"""Mask-propagation demo (counterpart of ``demo/demo.py``): propagate a
first-frame palette mask through a video and write a coloured overlay mp4.

    python -m vfs_tpu_torch.tools.demo CONFIG CHECKPOINT VIDEO MASK_PNG \\
        OUT_MP4 [--alpha 0.5] [--height 480] [--options k=v ...] \\
        [--device cpu]

MASK_PNG is a palette PNG (DAVIS-style integer labels) of the first
frame; CHECKPOINT a torchvision-layout ResNet ``.pth``. The frames are
resized so the short side is ``--height``, then ``VanillaTracker.
forward_test`` runs with the config's ``test_cfg`` on the card (``--device
cpu`` for the CPU). Unlike the JAX script, an output that
``cv2.VideoWriter`` cannot open raises instead of writing nothing.
"""

from __future__ import annotations

import argparse
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .analysis.common import add_device_arg


def parse_args(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description='mask propagation demo')
    parser.add_argument('config')
    parser.add_argument('checkpoint')
    parser.add_argument('video')
    parser.add_argument('mask')
    parser.add_argument('out')
    parser.add_argument('--alpha', type=float, default=0.5)
    parser.add_argument('--height', type=int, default=480,
                        help='short-side resize before propagation')
    parser.add_argument('--options', nargs='+', default=None)
    add_device_arg(parser)
    return parser.parse_args(argv)


def read_video(path: str) -> Tuple[List[np.ndarray], float]:
    """Every frame of a video as (H, W, 3) uint8 RGB, and its fps (24 if
    the container gives none)."""
    import cv2
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise IOError(f'cannot open {path}')
    fps = cap.get(cv2.CAP_PROP_FPS) or 24
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    cap.release()
    if not frames:
        raise IOError(f'no frames in {path}')
    return frames, fps


def propagate(frames_rgb: Sequence[np.ndarray], mask: np.ndarray, cfg,
              checkpoint: str, height: int = 480, device=None
              ) -> Tuple[List[np.ndarray], np.ndarray]:
    """Resize ``frames_rgb`` ((H, W, 3) uint8 RGB) to a short side of
    ``height``, the first-frame ``mask`` ((h, w) integer labels) to the
    same size with PIL's nearest rule, and propagate it with a
    ``VanillaTracker`` of ``cfg``'s backbone and ``test_cfg`` carrying
    ``checkpoint``'s weights, on ``device`` (CUDA unless given). Returns
    the resized frames and the (T, H', W') uint8 predictions (frame 0 is
    the mask)."""
    import cv2
    from PIL import Image

    from ..datasets.pipelines.augmentations import _rescale_size
    from ..models import build_model

    oh, ow = frames_rgb[0].shape[:2]
    new_w, new_h = _rescale_size((ow, oh), (np.inf, height))
    frames_rs = [cv2.resize(f, (new_w, new_h)) for f in frames_rgb]
    if mask.ndim == 3:
        mask = mask[..., 0]
    if mask.shape != (new_h, new_w):
        mask = np.asarray(Image.fromarray(mask).resize((new_w, new_h),
                                                       Image.NEAREST))
    norm = dict(mean=np.array([123.675, 116.28, 103.53], np.float32),
                std=np.array([58.395, 57.12, 57.375], np.float32))
    meta = [dict(original_shape=(new_h, new_w), img_norm_cfg=norm)]

    model_cfg = dict(type='VanillaTracker', backbone=dict(cfg.model.backbone))
    model_cfg['backbone']['pretrained'] = checkpoint
    model = build_model(model_cfg, test_cfg=cfg.test_cfg)
    model.init_weights()
    preds = model.forward_test(np.stack(frames_rs), mask.astype(np.uint8),
                               meta, device=device)[0]
    return frames_rs, preds


def overlay(frame: np.ndarray, pred: np.ndarray, alpha: float) -> np.ndarray:
    """``frame`` with the DAVIS palette colour of each labelled pixel
    blended in at ``alpha``; background pixels are left as they are."""
    from ..datasets.davis_dataset import PALETTE
    palette = np.asarray(PALETTE, np.uint8)
    color = palette[np.clip(pred, 0, len(palette) - 1)]
    out = frame.copy()
    fg = pred > 0
    out[fg] = (alpha * color[fg] + (1 - alpha) * frame[fg]).astype(np.uint8)
    return out


def main(argv: Optional[Sequence[str]] = None) -> str:
    args = parse_args(argv)
    import cv2
    from PIL import Image

    from ..device import resolve_device
    from ..utils import Config, parse_options

    device = resolve_device(args.device)
    cfg = Config.fromfile(args.config)
    if args.options:
        cfg.merge_from_dict(parse_options(args.options))
    frames, fps = read_video(args.video)
    mask = np.asarray(Image.open(args.mask))
    frames_rs, preds = propagate(frames, mask, cfg, args.checkpoint,
                                 args.height, device)
    h, w = frames_rs[0].shape[:2]
    writer = cv2.VideoWriter(args.out, cv2.VideoWriter_fourcc(*'mp4v'), fps,
                             (w, h))
    if not writer.isOpened():
        raise IOError(f'cv2.VideoWriter cannot write {args.out} (mp4v)')
    for frame, pred in zip(frames_rs, preds):
        writer.write(cv2.cvtColor(overlay(frame, pred, args.alpha),
                                  cv2.COLOR_RGB2BGR))
    writer.release()
    print(f'wrote {args.out} ({len(frames)} frames @ {fps:.1f} fps)')
    return args.out


if __name__ == '__main__':
    main()
