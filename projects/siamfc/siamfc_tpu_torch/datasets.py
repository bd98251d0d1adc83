"""Pair dataset + transforms for SiamFC linear probing (counterpart of
``siamfc_tpu/datasets.py``).

Reference: projects/siamfc-pytorch/siamfc/datasets.py:8-96 (validity
filters, <100-frame pair sampling) and transforms.py:91-140 (context crop ->
RandomStretch -> CenterCrop -> RandomCrop -> CenterCrop/none). Host-side
cv2/numpy; outputs channels-last float32 pairs.

Every random draw comes from an explicit ``np.random.RandomState``: the
``Pair``'s own, handed to the transforms with each call. The loader's
process workers reseed it with their worker seed (``Pair.seed_worker``).
The draws are the JAX classes' in the same order, so a ``Pair`` whose
state is seeded ``s`` gives the pairs the JAX ``Pair`` gives after
``np.random.seed(s)``.
"""

from __future__ import annotations

import glob
import os.path as osp
from typing import Optional

import cv2
import numpy as np

from .ops import crop_and_resize

INTERPS = (cv2.INTER_LINEAR, cv2.INTER_CUBIC, cv2.INTER_AREA,
           cv2.INTER_NEAREST, cv2.INTER_LANCZOS4)


class SequenceDataset:
    """Minimal got10k-style sequence collection: each item is
    ``(img_files, anno)`` with anno rows ``[x, y, w, h]`` (1-indexed
    corners). Built from a directory layout ``root/<seq>/...jpg`` +
    ``groundtruth.txt`` (GOT-10k / OTB style)."""

    def __init__(self, root, list_file=None, anno_name='groundtruth.txt',
                 delimiter=None):
        if list_file is not None:
            with open(list_file) as f:
                names = [ln.strip() for ln in f if ln.strip()]
        else:
            names = sorted(
                osp.basename(p) for p in glob.glob(osp.join(root, '*'))
                if osp.isdir(p))
        self.seq_dirs = [osp.join(root, n) for n in names]
        self.seq_names = names
        self.anno_name = anno_name
        self.delimiter = delimiter

    def __len__(self):
        return len(self.seq_dirs)

    def __getitem__(self, index):
        seq_dir = self.seq_dirs[index]
        img_files = sorted(glob.glob(osp.join(seq_dir, '*.jpg')))
        if not img_files:
            img_files = sorted(glob.glob(osp.join(seq_dir, 'img', '*.jpg')))
        with open(osp.join(seq_dir, self.anno_name)) as f:
            text = f.read().replace(',', ' ')
        anno = np.array([[float(t) for t in line.split()]
                         for line in text.strip().split('\n')])
        if anno.ndim == 1:
            anno = anno[None]
        return img_files, anno


class RandomStretch:
    def __init__(self, max_stretch=0.05):
        self.max_stretch = max_stretch

    def __call__(self, img, rng):
        interp = rng.choice(INTERPS)
        scale = 1.0 + rng.uniform(-self.max_stretch, self.max_stretch)
        out_size = (round(img.shape[1] * scale), round(img.shape[0] * scale))
        return cv2.resize(img, out_size, interpolation=int(interp))


class CenterCrop:
    def __init__(self, size):
        self.size = (int(size), int(size))

    def __call__(self, img, rng=None):
        h, w = img.shape[:2]
        tw, th = self.size
        i = round((h - th) / 2.)
        j = round((w - tw) / 2.)
        npad = max(0, -i, -j)
        if npad > 0:
            avg_color = np.mean(img, axis=(0, 1))
            img = cv2.copyMakeBorder(img, npad, npad, npad, npad,
                                     cv2.BORDER_CONSTANT, value=avg_color)
            i += npad
            j += npad
        return img[i:i + th, j:j + tw]


class RandomCrop:
    def __init__(self, size):
        self.size = (int(size), int(size))

    def __call__(self, img, rng):
        h, w = img.shape[:2]
        tw, th = self.size
        i = rng.randint(0, h - th + 1)
        j = rng.randint(0, w - tw + 1)
        return img[i:i + th, j:j + tw]


class SiamFCTransforms:
    """Reference transforms.py:91-140."""

    def __init__(self, exemplar_sz=127, instance_sz=255, context=0.5):
        self.exemplar_sz = exemplar_sz
        self.instance_sz = instance_sz
        self.context = context
        self._tz = [RandomStretch(), CenterCrop(instance_sz - 8),
                    RandomCrop(instance_sz - 2 * 8),
                    CenterCrop(exemplar_sz)]
        self._tx = [RandomStretch(), CenterCrop(instance_sz - 8),
                    RandomCrop(instance_sz - 2 * 8)]

    def _crop(self, img, box, out_size, rng):
        box = np.array([
            box[1] - 1 + (box[3] - 1) / 2,
            box[0] - 1 + (box[2] - 1) / 2,
            box[3], box[2]], np.float32)
        center, target_sz = box[:2], box[2:]
        context = self.context * np.sum(target_sz)
        size = np.sqrt(np.prod(target_sz + context))
        size *= out_size / self.exemplar_sz
        avg_color = np.mean(img, axis=(0, 1), dtype=float)
        interp = rng.choice(INTERPS)
        return crop_and_resize(img, center, size, out_size,
                               border_value=avg_color, interp=int(interp))

    def __call__(self, z, x, box_z, box_x, rng):
        z = self._crop(z, box_z, self.instance_sz, rng)
        x = self._crop(x, box_x, self.instance_sz, rng)
        for t in self._tz:
            z = t(z, rng)
        for t in self._tx:
            x = t(x, rng)
        return z.astype(np.float32), x.astype(np.float32)


class Pair:
    """GOT-10k pair sampler (reference datasets.py:8-96). ``rng``: the
    state every draw comes from (seeded 0 when not given)."""

    def __init__(self, seqs, transforms=None, pairs_per_seq=1,
                 rng: Optional[np.random.RandomState] = None):
        self.seqs = seqs
        self.transforms = transforms
        self.pairs_per_seq = pairs_per_seq
        self.rng = rng if rng is not None else np.random.RandomState(0)
        self.indices = self.rng.permutation(len(seqs))
        self.return_meta = getattr(seqs, 'return_meta', False)

    def seed_worker(self, seed: int):
        """A loader process worker's stream (``datasets.builder``)."""
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.indices) * self.pairs_per_seq

    def __getitem__(self, index):
        index = self.indices[index % len(self.indices)]
        if self.return_meta:
            img_files, anno, meta = self.seqs[index]
            vis_ratios = meta.get('cover', None)
        else:
            img_files, anno = self.seqs[index][:2]
            vis_ratios = None
        img0 = cv2.imread(img_files[0], cv2.IMREAD_COLOR)
        val_indices = self._filter(img0, anno, vis_ratios)
        if len(val_indices) < 2:
            return self.__getitem__(self.rng.choice(len(self)))
        rand_z, rand_x = self._sample_pair(val_indices)
        z = cv2.cvtColor(cv2.imread(img_files[rand_z], cv2.IMREAD_COLOR),
                         cv2.COLOR_BGR2RGB)
        x = cv2.cvtColor(cv2.imread(img_files[rand_x], cv2.IMREAD_COLOR),
                         cv2.COLOR_BGR2RGB)
        item = (z, x, anno[rand_z], anno[rand_x])
        if self.transforms is not None:
            z, x = self.transforms(*item, rng=self.rng)
            return {'z': z, 'x': x}
        return {'z': z, 'x': x, 'box_z': anno[rand_z], 'box_x': anno[rand_x]}

    def _sample_pair(self, indices):
        n = len(indices)
        assert n > 0
        if n == 1:
            return indices[0], indices[0]
        if n == 2:
            return indices[0], indices[1]
        for _ in range(100):
            rand_z, rand_x = np.sort(
                self.rng.choice(indices, 2, replace=False))
            if rand_x - rand_z < 100:
                return rand_z, rand_x
        rand_z = self.rng.choice(indices)
        return rand_z, rand_z

    def _filter(self, img0, anno, vis_ratios=None):
        size = np.array(img0.shape[1::-1])[np.newaxis, :]
        areas = anno[:, 2] * anno[:, 3]
        c1 = areas >= 20
        c2 = np.all(anno[:, 2:] >= 20, axis=1)
        c3 = np.all(anno[:, 2:] <= 500, axis=1)
        c4 = np.all((anno[:, 2:] / size) >= 0.01, axis=1)
        c5 = np.all((anno[:, 2:] / size) <= 0.5, axis=1)
        c6 = (anno[:, 2] / np.maximum(1, anno[:, 3])) >= 0.25
        c7 = (anno[:, 2] / np.maximum(1, anno[:, 3])) <= 4
        if vis_ratios is not None:
            c8 = (vis_ratios > max(1, vis_ratios.max() * 0.3))
        else:
            c8 = np.ones_like(c1)
        mask = np.logical_and.reduce((c1, c2, c3, c4, c5, c6, c7, c8))
        return np.where(mask)[0]
