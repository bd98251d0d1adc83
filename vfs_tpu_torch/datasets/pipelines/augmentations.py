"""Geometric and photometric transforms of the eval pipeline (host-side
numpy, cv2 and PIL; counterpart of ``Resize``, ``Flip`` and ``Normalize``
in ``vfs_tpu/datasets/pipelines/augmentations.py``, reference:
mmaction/datasets/pipelines/augmentations.py)."""

from __future__ import annotations

import numpy as np

from ..registry import PIPELINES


def _rescale_size(old_size, scale):
    """mmcv.rescale_size parity: fit (w, h) into scale keeping ratio."""
    w, h = old_size
    if isinstance(scale, (float, int)) and not isinstance(scale, bool):
        scale_factor = scale
    elif isinstance(scale, tuple):
        max_long_edge = max(scale)
        max_short_edge = min(scale)
        scale_factor = min(max_long_edge / max(h, w),
                           max_short_edge / min(h, w))
    else:
        raise TypeError(f'scale must be number or tuple, got {type(scale)}')
    new_w = int(w * scale_factor + 0.5)
    new_h = int(h * scale_factor + 0.5)
    return new_w, new_h


def _imresize(img, size_wh, interpolation='bilinear'):
    import cv2
    inter = {'bilinear': cv2.INTER_LINEAR, 'nearest': cv2.INTER_NEAREST,
             'bicubic': cv2.INTER_CUBIC, 'area': cv2.INTER_AREA}[
                 interpolation]
    return cv2.resize(img, size_wh, interpolation=inter)


def _pil_nearest_imresize(img, size_wh):
    from PIL import Image
    pil = Image.fromarray(img)
    return np.asarray(pil.resize(size_wh, Image.NEAREST))


def _should_generate_new(i, results, same_on_clip, same_across_clip,
                         same_clip_indices, same_frame_indices):
    """Per-frame re-randomization gate (reference augmentations.py:285-300),
    called for every frame including i=0; clip membership is
    ``i // clip_len`` for every transform, as in the JAX package."""
    clip_len = results['clip_len']
    is_new_clip = (not same_across_clip) and i % clip_len == 0 and i > 0
    generate_new = (not same_on_clip) or is_new_clip
    if same_clip_indices is not None:
        keep_same = i // clip_len in same_clip_indices
        generate_new = generate_new and not keep_same
    if same_frame_indices is not None:
        keep_same = i % clip_len in same_frame_indices
        generate_new = generate_new and not keep_same
    return generate_new


@PIPELINES.register_module()
class Resize:
    """Resize (reference augmentations.py:487-597). ``scale=(-1, N)`` with
    keep_ratio rescales the short side to N. Also resizes ``ref_seg_map``:
    PIL-nearest for uint8 label maps, cv2-bilinear for float maps
    (:577-587 — the PIL-nearest choice is a J&F parity trap)."""

    def __init__(self, scale, keep_ratio=True, interpolation='bilinear'):
        if isinstance(scale, tuple):
            max_long = max(scale)
            if min(scale) == -1:
                scale = (np.inf, max_long)
        self.scale = scale
        self.keep_ratio = keep_ratio
        self.interpolation = interpolation

    def __call__(self, results):
        if 'scale_factor' not in results:
            results['scale_factor'] = np.array([1, 1], dtype=np.float32)
        img_h, img_w = results['img_shape']
        if self.keep_ratio:
            new_w, new_h = _rescale_size((img_w, img_h), self.scale)
        else:
            new_w, new_h = self.scale
        scale_factor = np.array([new_w / img_w, new_h / img_h],
                                dtype=np.float32)
        results['img_shape'] = (new_h, new_w)
        results['keep_ratio'] = self.keep_ratio
        results['scale_factor'] = results['scale_factor'] * scale_factor
        results['imgs'] = [
            _imresize(img, (new_w, new_h), self.interpolation)
            for img in results['imgs']
        ]
        if 'ref_seg_map' in results:
            if results['ref_seg_map'].dtype == np.uint8:
                results['ref_seg_map'] = _pil_nearest_imresize(
                    results['ref_seg_map'], (new_w, new_h))
            else:
                results['ref_seg_map'] = _imresize(
                    results['ref_seg_map'], (new_w, new_h), 'bilinear')
        return results


@PIPELINES.register_module()
class Flip:
    """Horizontal/vertical flip with per-frame re-randomization
    (reference augmentations.py:600-680)."""

    def __init__(self, flip_ratio=0.5, direction='horizontal',
                 same_on_clip=True, same_across_clip=True,
                 same_clip_indices=None, same_frame_indices=None):
        assert direction in ('horizontal', 'vertical')
        self.flip_ratio = flip_ratio
        self.direction = direction
        self.same_on_clip = same_on_clip
        self.same_across_clip = same_across_clip
        self.same_clip_indices = same_clip_indices
        self.same_frame_indices = same_frame_indices

    def __call__(self, results):
        flip = np.random.rand() < self.flip_ratio
        results['flip'] = flip
        results['flip_direction'] = self.direction
        axis = 1 if self.direction == 'horizontal' else 0
        for i in range(len(results['imgs'])):
            if _should_generate_new(
                    i, results, self.same_on_clip, self.same_across_clip,
                    self.same_clip_indices, self.same_frame_indices):
                flip = np.random.rand() < self.flip_ratio
            if flip:
                results['imgs'][i] = np.flip(results['imgs'][i],
                                             axis=axis).copy()
        return results


@PIPELINES.register_module()
class Normalize:
    """Mean/std normalize RGB frames into a float32 (T, H, W, C) stack
    (reference augmentations.py:711-758). ``on_device=True`` keeps the
    frames uint8 and leaves (x - mean) / std to the tracker, on the card:
    a quarter of the host-to-device bytes, the same numbers."""

    def __init__(self, mean, std, to_bgr=False, adjust_magnitude=False,
                 on_device=False):
        self.mean = np.array(mean, dtype=np.float32)
        self.std = np.array(std, dtype=np.float32)
        self.to_bgr = to_bgr
        self.on_device = on_device

    def __call__(self, results):
        imgs = np.stack(results['imgs'])
        if self.to_bgr:
            imgs = imgs[..., ::-1]
        if not self.on_device:
            imgs = (imgs.astype(np.float32) - self.mean) / self.std
        results['imgs'] = imgs
        results['img_norm_cfg'] = dict(mean=self.mean, std=self.std,
                                       to_bgr=self.to_bgr)
        return results
