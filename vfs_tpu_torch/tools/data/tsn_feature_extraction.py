"""Per-snippet TSN scores of untrimmed rawframe videos, the BSN/BMN
feature-preparation step (counterpart of
``tools/data/activitynet/tsn_feature_extraction.py``; reference:
tools/data/activitynet/tsn_feature_extraction.py:1-140).

    python -m vfs_tpu_torch.tools.data.tsn_feature_extraction \\
        --data-prefix RAWFRAMES --output-prefix FEATURES \\
        --data-list LIST [--ckpt r50.pth] [--frame-interval 16] \\
        [--batch-size 64] [--part 0 --total 1] [--device cpu]

Each LIST line is ``frame_dir num_frames output_file``; every
``--frame-interval``-th frame (``UntrimmedSampleFrames``), resized to a
short side of ``CROP`` (256) and centre-cropped to ``CROP`` square, goes
through a ``Recognizer2D`` of ResNet-50 and ``TSNHead``
(``--num-classes``), on the card unless ``--device cpu``,
``--batch-size`` snippets a forward in exact fp32; the (snippets,
classes) scores are pickled to ``output_prefix/output_file``. ``--ckpt``
is a torchvision-layout ResNet-50 ``.pth`` loaded into the backbone;
without it the weights are seeded (seed 0). The JAX tool takes ``--ckpt`` but never loads it.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import pickle
from typing import List, Optional, Sequence

import numpy as np

from ..analysis.common import add_device_arg

MEAN = [123.675, 116.28, 103.53]
STD = [58.395, 57.12, 57.375]
CROP = 256


def parse_args(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description='Extract TSN features')
    parser.add_argument('--data-prefix', default='')
    parser.add_argument('--output-prefix', default='')
    parser.add_argument('--data-list', required=True,
                        help='lines of `frame_dir num_frames output_file`')
    parser.add_argument('--frame-interval', type=int, default=16)
    parser.add_argument('--clip-len', type=int, default=1)
    parser.add_argument('--ckpt', default=None,
                        help='torchvision-layout backbone checkpoint '
                             '(.pth) for the R50 feature extractor')
    parser.add_argument('--num-classes', type=int, default=200)
    parser.add_argument('--batch-size', type=int, default=64,
                        help='snippets a forward')
    parser.add_argument('--part', type=int, default=0)
    parser.add_argument('--total', type=int, default=1)
    add_device_arg(parser)
    return parser.parse_args(argv)


def build_extractor(num_classes: int, ckpt: Optional[str], device):
    """The R50 TSN recognizer in eval mode on ``device``."""
    import torch

    from ...checkpoint import load_backbone_state, load_torchvision_resnet
    from ...models import build_model
    model = build_model(
        dict(type='Recognizer2D',
             backbone=dict(type='ResNet', depth=50, norm_eval=False),
             cls_head=dict(type='TSNHead', num_classes=num_classes,
                           in_channels=2048, spatial_type='avg',
                           consensus=dict(type='AvgConsensus', dim=1))),
        test_cfg=dict(average_clips=None))
    model.init_weights(torch.Generator().manual_seed(0))
    if ckpt:
        load_backbone_state(model.backbone, load_torchvision_resnet(ckpt))
    return model.to(device).eval()


def main(argv: Optional[Sequence[str]] = None) -> List[str]:
    """Extract; returns the written paths."""
    args = parse_args(argv)
    import torch

    from ...datasets.pipelines import Compose
    from ...device import exact_fp32, resolve_device

    device = resolve_device(args.device)
    pipeline = Compose([
        dict(type='UntrimmedSampleFrames', clip_len=args.clip_len,
             frame_interval=args.frame_interval),
        dict(type='RawFrameDecode'),
        dict(type='Resize', scale=(-1, CROP)),
        dict(type='CenterCrop', crop_size=CROP),
        dict(type='Normalize', mean=MEAN, std=STD),
        dict(type='FormatShape', input_format='NHWC'),
        dict(type='Collect', keys=['imgs'], meta_keys=[]),
    ])
    model = build_extractor(args.num_classes, args.ckpt, device)
    items = [ln.strip() for ln in open(args.data_list) if ln.strip()]
    items = items[args.part::args.total]
    written = []
    for n, item in enumerate(items):
        frame_dir, length, output_file = item.split()
        sample = pipeline(dict(
            frame_dir=osp.join(args.data_prefix, frame_dir),
            total_frames=int(length), filename_tmpl='img_{:05d}.jpg',
            start_index=1, modality='RGB'))
        imgs = np.asarray(sample['imgs'], np.float32)  # (snippets, H, W, C)
        feats = []
        for start in range(0, len(imgs), args.batch_size):
            part = torch.as_tensor(imgs[start:start + args.batch_size])
            # each snippet is a video of one segment
            with torch.no_grad(), exact_fp32():
                feats.append(model(part.to(device)[:, None],
                                   return_loss=False).cpu().numpy())
        feat = np.concatenate(feats)
        out_path = osp.join(args.output_prefix, output_file)
        os.makedirs(osp.dirname(out_path) or '.', exist_ok=True)
        with open(out_path, 'wb') as f:
            pickle.dump(feat, f)
        written.append(out_path)
        print(f'[{n + 1}/{len(items)}] {frame_dir}: {feat.shape} '
              f'-> {out_path}')
    return written


if __name__ == '__main__':
    main()
