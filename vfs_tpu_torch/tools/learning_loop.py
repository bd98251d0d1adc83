"""Learning loop: pretraining must improve correspondence (counterpart of
``tools/learning_loop.py``).

The VFS claim at fixture scale, through the whole port: a deterministic
synthetic world with ground-truth temporal correspondence (textured
sprites moving over a textured background, per-frame illumination jitter,
JPEG rawframes on disk), SimSiam pretraining of the r18 model on it
through ``apis.train.train_model`` (RawframeDataset and the r18 train
pipeline with per-frame crops and flips), the final backbone written as a
torchvision-layout ``.pth``, and a ``VanillaTracker`` DAVIS-protocol eval
of pretrained against random-init features:

- DAVIS J&F on held-out synthetic videos (ground-truth masks on every
  frame);
- correspondence retrieval: a feature cell inside sprite k at frame 0
  must have its cosine nearest neighbour inside sprite k's mask at frame
  t (the motion is known, so this is exact).

Usage:
    python -m vfs_tpu_torch.tools.learning_loop [--device cpu] [--seed 0]
        [--epochs 24] [--work-dir work_dirs/learning_loop]

Runs on CUDA unless ``--device`` says otherwise. Prints one JSON line with
both J&F and retrieval values and their margins.
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import shutil
from typing import Optional, Sequence

import numpy as np

MEAN = [123.675, 116.28, 103.53]
STD = [58.395, 57.12, 57.375]

TRAIN_HW = (72, 96)    # stored frames
CROP = 64              # train crop fed to the backbone
# held-out eval videos: a 16x22 feature grid at stride 8 (a coarser grid
# caps J&F by quantisation for trained and random features alike)
VAL_HW = (128, 176)


def _texture(rng, h, w, base_rgb, contrast=60.0, cell=6):
    """Blobby colour texture: low-res noise around ``base_rgb`` upsampled
    bilinearly, plus fine grain."""
    from PIL import Image
    lo = rng.randn(max(h // cell, 2), max(w // cell, 2), 3) * contrast
    lo = np.asarray(Image.fromarray(
        np.clip(lo + 128, 0, 255).astype(np.uint8)).resize(
            (w, h), Image.BILINEAR), np.float32) - 128
    fine = rng.randn(h, w, 3) * 8
    return np.clip(np.asarray(base_rgb, np.float32) + lo + fine, 0, 255)


def _sprite_mask(rng, size):
    """A rotated ellipse mask (boundaries matter for F)."""
    yy, xx = np.mgrid[:size, :size].astype(np.float32)
    c = (size - 1) / 2
    ry = size * (0.32 + 0.1 * rng.rand())
    rx = size * (0.32 + 0.1 * rng.rand())
    ang = rng.rand() * np.pi
    ys, xs = (yy - c), (xx - c)
    u = ys * np.cos(ang) + xs * np.sin(ang)
    v = -ys * np.sin(ang) + xs * np.cos(ang)
    return (u / ry) ** 2 + (v / rx) ** 2 <= 1.0


def _render_video(rng, n_frames, hw, n_sprites=2):
    """Returns (frames uint8 (T, H, W, 3), masks uint8 (T, H, W))."""
    h, w = hw
    # background and sprites share a palette family, so colour alone is
    # ambiguous for random features
    hue = rng.randint(0, 3)
    base_bg = np.roll([150, 110, 80], hue)
    bg = _texture(rng, h, w, base_bg, contrast=45.0, cell=8)
    sprites = []
    for k in range(n_sprites):
        size = int(rng.randint(20, 27))
        tex = _texture(rng, size, size,
                       np.roll([160, 120, 70], hue + 1 + k) +
                       rng.randint(-25, 25, 3), contrast=70.0, cell=4)
        mask = _sprite_mask(rng, size)
        pos = np.array([rng.randint(0, h - size),
                        rng.randint(0, w - size)], np.float32)
        vel = rng.uniform(-2.5, 2.5, 2)
        sprites.append(dict(size=size, tex=tex, mask=mask, pos=pos,
                            vel=vel))
    frames = np.empty((n_frames, h, w, 3), np.uint8)
    masks = np.zeros((n_frames, h, w), np.uint8)
    for t in range(n_frames):
        canvas = bg.copy()
        for k, sp in enumerate(sprites):
            size = sp['size']
            y, x = np.round(sp['pos']).astype(int)
            y = np.clip(y, 0, h - size)
            x = np.clip(x, 0, w - size)
            region = canvas[y:y + size, x:x + size]
            region[sp['mask']] = sp['tex'][sp['mask']]
            masks[t, y:y + size, x:x + size][sp['mask']] = k + 1
            # integrate the motion, bounce at the borders
            sp['pos'] += sp['vel']
            for d, lim in ((0, h - size), (1, w - size)):
                if sp['pos'][d] < 0 or sp['pos'][d] > lim:
                    sp['vel'][d] *= -1
                    sp['pos'][d] = np.clip(sp['pos'][d], 0, lim)
        gain = 0.85 + 0.3 * rng.rand()  # per-frame illumination jitter
        frames[t] = np.clip(canvas * gain, 0, 255).astype(np.uint8)
    return frames, masks


def make_synthetic_world(root, n_train=24, n_val=12, train_frames=16,
                         val_frames=12, seed=0):
    """Write the train rawframes and the DAVIS-layout val videos under
    ``root``, deterministically in ``seed``; the val split is drawn first,
    so it does not depend on ``n_train``. Returns (train_ann, val_ann,
    img_root, ann_root)."""
    from PIL import Image

    from ..datasets.davis_dataset import PALETTE
    rng = np.random.RandomState(seed)
    train_root = osp.join(root, 'train')
    img_root = osp.join(root, 'JPEGImages/480p')
    ann_root = osp.join(root, 'Annotations/480p')

    val_videos = [_render_video(rng, val_frames, VAL_HW)
                  for _ in range(n_val)]

    train_lines = []
    for v in range(n_train):
        name = f'train{v:03}'
        d = osp.join(train_root, name)
        os.makedirs(d, exist_ok=True)
        frames, _ = _render_video(rng, train_frames, TRAIN_HW)
        for t in range(train_frames):
            Image.fromarray(frames[t]).save(
                osp.join(d, f'img_{t + 1:05}.jpg'), quality=90)
        train_lines.append(f'{name} {train_frames} 0\n')
    train_ann = osp.join(root, 'train_list.txt')
    with open(train_ann, 'w') as f:
        f.writelines(train_lines)

    val_lines = []
    for v, (frames, masks) in enumerate(val_videos):
        name = f'val{v:03}'
        os.makedirs(osp.join(img_root, name), exist_ok=True)
        os.makedirs(osp.join(ann_root, name), exist_ok=True)
        for t in range(val_frames):
            Image.fromarray(frames[t]).save(
                osp.join(img_root, name, f'{t:05}.jpg'), quality=90)
            ann = Image.fromarray(masks[t])
            ann.putpalette(np.asarray(PALETTE, np.uint8).ravel())
            ann.save(osp.join(ann_root, name, f'{t:05}.png'))
        val_lines.append(f'{name} {val_frames} 0\n')
    val_ann = osp.join(root, 'val_list.txt')
    with open(val_ann, 'w') as f:
        f.writelines(val_lines)
    return train_ann, val_ann, img_root, ann_root


HEAD_CFG = dict(
    type='SimSiamHead', in_channels=512, norm_cfg=dict(type='SyncBN'),
    num_projection_fcs=3, projection_mid_channels=128,
    projection_out_channels=128, num_predictor_fcs=2,
    predictor_mid_channels=64, predictor_out_channels=128,
    with_norm=True, loss_feat=dict(type='CosineSimLoss', negative=False),
    spatial_type='avg')

TEST_CFG = dict(precede_frames=20, topk=10, temperature=0.07,
                strides=(1, 2, 1, 1), out_indices=(2,), neighbor_range=8,
                with_first=True, with_first_neighbor=True, batch_step=4)

TRAIN_PIPELINE = [
    dict(type='SampleFrames', clip_len=1, frame_interval=0, num_clips=8,
         out_of_bound_opt='loop'),
    dict(type='Clip2Frame', clip_len=4),
    dict(type='RawFrameDecode'),
    dict(type='RandomResizedCrop', area_range=(0.2, 1.0),
         same_on_clip=False, same_across_clip=False),
    dict(type='Resize', scale=(CROP, CROP), keep_ratio=False),
    dict(type='Flip', flip_ratio=0.5, same_on_clip=False,
         same_across_clip=False),
    dict(type='Normalize', mean=MEAN, std=STD, to_bgr=False),
    dict(type='FormatShape', input_format='NCTHW'),
    dict(type='Collect', keys=['imgs', 'label'], meta_keys=[]),
]


def pretrain(work_dir, train_ann, total_epochs=24, repeat=4, batch=8,
             lr=0.05, seed=0, device=None):
    """The r18 pretraining recipe scaled to the synthetic world, through
    ``train_model`` on ``device``; returns the torchvision-layout ``.pth``
    of the final backbone."""
    import torch

    from ..apis.train import train_model
    from ..datasets import build_dataset
    from ..models import build_model
    from ..utils import Config
    from .convert_to_pretrained import state_to_torchvision

    dataset = build_dataset(dict(
        type='RepeatDataset', times=repeat,
        dataset=dict(type='RawframeDataset', ann_file=train_ann,
                     data_prefix=osp.join(osp.dirname(train_ann), 'train'),
                     pipeline=TRAIN_PIPELINE)))
    cfg = Config.fromdict(dict(
        work_dir=work_dir, seed=seed, auto_resume=False,
        data=dict(videos_per_gpu=batch, workers_per_gpu=2),
        optimizer=dict(type='SGD', lr=lr, momentum=0.9, weight_decay=1e-4),
        optimizer_config=dict(grad_clip=None),
        lr_config=dict(policy='CosineAnnealing', min_lr=0, by_epoch=False),
        total_epochs=total_epochs,
        checkpoint_config=dict(interval=max(total_epochs // 2, 1)),
        log_config=dict(interval=20),
    ))
    model = build_model(
        dict(type='SimSiamBaseTracker',
             backbone=dict(type='ResNet', depth=18, out_indices=(3,),
                           zero_init_residual=True),
             img_head=dict(HEAD_CFG)),
        train_cfg=dict(intra_video=True))
    state = train_model(model, dataset, cfg, device=device)
    pth = osp.join(work_dir, 'pretrained_tv.pth')
    torch.save(state_to_torchvision(state.model.state_dict()), pth)
    return pth


def build_tracker(pretrained=None, seed=0):
    """The r18 ``VanillaTracker`` of ``TEST_CFG``: random weights from
    ``seed``, or ``pretrained`` (a torchvision-layout ``.pth``)."""
    import torch

    from ..models import build_model
    backbone = dict(type='ResNet', depth=18, out_indices=(3,))
    if pretrained:
        backbone['pretrained'] = pretrained
    model = build_model(dict(type='VanillaTracker', backbone=backbone),
                        test_cfg=dict(TEST_CFG))
    model.init_weights(torch.Generator().manual_seed(seed))
    return model


def eval_jf(model, root, val_ann, img_root, ann_root, device=None):
    """DAVIS-protocol J&F-Mean on the held-out synthetic videos."""
    from ..apis.test import single_process_test
    from ..datasets import build_dataset
    val_pipeline = [
        dict(type='SequentialSampleFrames', frame_interval=1),
        dict(type='RawFrameDecode'),
        dict(type='Resize', scale=(-1, VAL_HW[0]), keep_ratio=True),
        dict(type='Flip', flip_ratio=0),
        dict(type='Normalize', mean=MEAN, std=STD, to_bgr=False),
        dict(type='FormatShape', input_format='NCTHW'),
        dict(type='Collect', keys=['imgs', 'ref_seg_map'],
             meta_keys=('frame_dir', 'frame_inds', 'original_shape',
                        'seg_map')),
    ]
    dataset = build_dataset(dict(
        type='DavisDataset', ann_file=val_ann, data_prefix=img_root,
        anno_prefix=ann_root, data_root=root, pipeline=val_pipeline,
        test_mode=True))
    results = single_process_test(model, dataset, device=device)
    metrics = dataset.evaluate(results, metrics='davis')
    return float(metrics['J&F-Mean'])


def eval_retrieval(model, img_root, ann_root, device=None):
    """Ground-truth correspondence retrieval at the feature grid: each
    cell inside sprite k at frame 0 must have its cosine nearest neighbour
    among the frame-t cells inside sprite k's frame-t mask."""
    import torch
    from PIL import Image

    from ..device import resolve_device
    dev = resolve_device(device)
    model.to(dev).eval()
    if dev.type == 'cuda':
        model.backbone.to(memory_format=torch.channels_last)
    mean = torch.as_tensor(np.asarray(MEAN, np.float32), device=dev)
    std = torch.as_tensor(np.asarray(STD, np.float32), device=dev)
    correct = total = 0
    for name in sorted(os.listdir(img_root)):
        fdir = osp.join(img_root, name)
        files = sorted(os.listdir(fdir))
        imgs = np.stack([np.asarray(Image.open(osp.join(fdir, f)))
                         for f in files])
        anns = np.stack(
            [np.asarray(Image.open(osp.join(ann_root, name,
                                            f.replace('.jpg', '.png'))))
             for f in files])
        t = imgs.shape[0]
        bs = int(model.test_cfg.get('batch_step', 4))
        feats = model._extract_feats(torch.as_tensor(imgs, device=dev), bs,
                                     mean, std)[0].cpu().numpy()
        fh, fw = feats.shape[1:3]
        # majority label per cell by a nearest resize of the masks
        cell_labels = np.stack([np.asarray(
            Image.fromarray(a).resize((fw, fh), Image.NEAREST))
            for a in anns])
        f = feats / (np.linalg.norm(feats, axis=-1, keepdims=True) + 1e-8)
        f0 = f[0].reshape(-1, f.shape[-1])
        lab0 = cell_labels[0].ravel()
        src = lab0 > 0
        if not src.any():
            continue
        for tt in range(1, t):
            sims = f0[src] @ f[tt].reshape(-1, f.shape[-1]).T
            nn_lab = cell_labels[tt].ravel()[np.argmax(sims, axis=1)]
            correct += int((nn_lab == lab0[src]).sum())
            total += int(src.sum())
    return correct / max(total, 1)


def main(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description='Pretrain on a synthetic '
                                     'world and score the correspondence')
    parser.add_argument('--work-dir', default='work_dirs/learning_loop')
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--epochs', type=int, default=24)
    parser.add_argument('--repeat', type=int, default=4)
    parser.add_argument('--n-train', type=int, default=24)
    parser.add_argument('--lr', type=float, default=0.05)
    parser.add_argument('--keep', action='store_true',
                        help='keep the work dir (default: fresh start)')
    parser.add_argument('--device', default=None,
                        help="device to run on; CUDA unless given "
                             "(e.g. 'cpu')")
    args = parser.parse_args(argv)

    if not args.keep and osp.isdir(args.work_dir):
        shutil.rmtree(args.work_dir)
    data_root = osp.join(args.work_dir, 'data')
    os.makedirs(data_root, exist_ok=True)
    train_ann, val_ann, img_root, ann_root = make_synthetic_world(
        data_root, n_train=args.n_train, seed=args.seed)

    pth = pretrain(args.work_dir, train_ann, total_epochs=args.epochs,
                   repeat=args.repeat, lr=args.lr, seed=args.seed,
                   device=args.device)

    results = {}
    for tag, pretrained in (('random', None), ('pretrained', pth)):
        model = build_tracker(pretrained, seed=args.seed)
        results[f'jf_{tag}'] = round(eval_jf(
            model, data_root, val_ann, img_root, ann_root, args.device), 4)
        results[f'retrieval_{tag}'] = round(
            eval_retrieval(model, img_root, ann_root, args.device), 4)
        del model
    results['jf_margin'] = round(
        results['jf_pretrained'] - results['jf_random'], 4)
    results['retrieval_margin'] = round(
        results['retrieval_pretrained'] - results['retrieval_random'], 4)
    results['seed'] = args.seed
    results['arm'] = 'vfs_tpu_torch'
    results['steps'] = args.epochs * (args.n_train * args.repeat // 8)
    print(json.dumps(results))
    return results


if __name__ == '__main__':
    main()
