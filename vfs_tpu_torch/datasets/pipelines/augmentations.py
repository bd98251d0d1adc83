"""Geometric and photometric transforms (host-side numpy, cv2 and PIL;
counterpart of ``vfs_tpu/datasets/pipelines/augmentations.py``,
reference: mmaction/datasets/pipelines/augmentations.py). The random ones
draw from ``np.random`` and ``random`` in the JAX package's order, so
equal seeds give equal frames; ``same_on_clip=False`` re-draws per frame
and ``same_across_clip=False`` at clip boundaries (VFS's per-frame
augmentation)."""

from __future__ import annotations

import random

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
class RandomResizedCrop:
    """Random area/aspect crop (reference augmentations.py:171-330)."""

    def __init__(self, area_range=(0.08, 1.0),
                 aspect_ratio_range=(3 / 4, 4 / 3), same_on_clip=True,
                 same_across_clip=True, same_clip_indices=None,
                 same_frame_indices=None):
        self.area_range = area_range
        self.aspect_ratio_range = aspect_ratio_range
        self.same_on_clip = same_on_clip
        self.same_across_clip = same_across_clip
        self.same_clip_indices = same_clip_indices
        self.same_frame_indices = same_frame_indices

    @staticmethod
    def get_crop_bbox(img_shape, area_range, aspect_ratio_range,
                      max_attempts=10):
        img_h, img_w = img_shape
        area = img_h * img_w
        min_ar, max_ar = aspect_ratio_range
        aspect_ratios = np.exp(np.random.uniform(
            np.log(min_ar), np.log(max_ar), size=max_attempts))
        target_areas = np.random.uniform(*area_range,
                                         size=max_attempts) * area
        candidate_w = np.round(np.sqrt(target_areas *
                                       aspect_ratios)).astype(np.int32)
        candidate_h = np.round(np.sqrt(target_areas /
                                       aspect_ratios)).astype(np.int32)
        for i in range(max_attempts):
            crop_w, crop_h = candidate_w[i], candidate_h[i]
            if crop_h <= img_h and crop_w <= img_w:
                x = random.randint(0, img_w - crop_w)
                y = random.randint(0, img_h - crop_h)
                return x, y, x + crop_w, y + crop_h
        crop_size = min(img_h, img_w)
        x = (img_w - crop_size) // 2
        y = (img_h - crop_size) // 2
        return x, y, x + crop_size, y + crop_size

    def __call__(self, results):
        img_h, img_w = results['img_shape']
        bbox = self.get_crop_bbox((img_h, img_w), self.area_range,
                                  self.aspect_ratio_range)
        for i, img in enumerate(results['imgs']):
            if _should_generate_new(
                    i, results, self.same_on_clip, self.same_across_clip,
                    self.same_clip_indices, self.same_frame_indices):
                bbox = self.get_crop_bbox((img_h, img_w), self.area_range,
                                          self.aspect_ratio_range)
            left, top, right, bottom = bbox
            results['imgs'][i] = img[top:bottom, left:right]
        left, top, right, bottom = bbox
        results['crop_bbox'] = np.array([left, top, right, bottom])
        results['img_shape'] = (bottom - top, right - left)
        return results


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


@PIPELINES.register_module()
class ColorJitter:
    """Brightness/contrast/saturation/hue jitter with probability ``p``
    (reference augmentations.py:1280-1320, torchvision parameterization)."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0, p=1.0,
                 same_on_clip=True, same_across_clip=True):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue
        self.p = p
        self.same_on_clip = same_on_clip
        self.same_across_clip = same_across_clip

    def _sample(self):
        if np.random.rand() >= self.p:
            return None
        b = np.random.uniform(max(0, 1 - self.brightness),
                              1 + self.brightness)
        c = np.random.uniform(max(0, 1 - self.contrast), 1 + self.contrast)
        s = np.random.uniform(max(0, 1 - self.saturation),
                              1 + self.saturation)
        h = np.random.uniform(-self.hue, self.hue)
        # torchvision get_params applies the four ops in a random
        # permutation (the reference delegates to torchvision,
        # augmentations.py:1304-1306); torch's randperm stream is
        # approximated with the np stream here
        order = tuple(np.random.permutation(4))
        return (b, c, s, h, order)

    @staticmethod
    def _apply(img, params):
        """torchvision adjust_* semantics in float math (cv2 HSV for the
        hue rotate — not PIL-bit-exact, a documented approximation):
        contrast blends against the GRAYSCALE mean and saturation blends
        each pixel toward its grayscale value, ops in ``params`` order."""
        import cv2
        if params is None:
            return img
        b, c, s, h, order = params
        gray_w = np.array([0.299, 0.587, 0.114], np.float32)
        img = img.astype(np.float32)
        for op in order:
            if op == 0:  # brightness
                img = np.clip(img * b, 0, 255)
            elif op == 1:  # contrast (gray-mean blend)
                mean = (img @ gray_w).mean()
                img = np.clip((img - mean) * c + mean, 0, 255)
            elif op == 2:  # saturation (per-pixel gray blend)
                g = (img @ gray_w)[..., None]
                img = np.clip(g + (img - g) * s, 0, 255)
            else:  # hue
                hsv = cv2.cvtColor(np.clip(img, 0, 255).astype(np.uint8),
                                   cv2.COLOR_RGB2HSV).astype(np.float32)
                hsv[..., 0] = (hsv[..., 0] + h * 180) % 180
                hsv = np.clip(hsv, 0,
                              [179, 255, 255]).astype(np.uint8)
                img = cv2.cvtColor(hsv,
                                   cv2.COLOR_HSV2RGB).astype(np.float32)
        return np.clip(img, 0, 255).astype(np.uint8)

    def __call__(self, results):
        params = self._sample()
        for i in range(len(results['imgs'])):
            if _should_generate_new(
                    i, results, self.same_on_clip, self.same_across_clip,
                    None, None):
                params = self._sample()
            results['imgs'][i] = self._apply(results['imgs'][i], params)
        return results


@PIPELINES.register_module()
class RandomGrayScale:
    """Random grayscale (reference augmentations.py:1257-1278)."""

    def __init__(self, p=0.2, same_on_clip=True, same_across_clip=True):
        self.p = p
        self.same_on_clip = same_on_clip
        self.same_across_clip = same_across_clip

    def __call__(self, results):
        import cv2
        gray = np.random.rand() < self.p
        for i in range(len(results['imgs'])):
            if _should_generate_new(
                    i, results, self.same_on_clip, self.same_across_clip,
                    None, None):
                gray = np.random.rand() < self.p
            if gray:
                g = cv2.cvtColor(results['imgs'][i], cv2.COLOR_RGB2GRAY)
                results['imgs'][i] = np.stack([g, g, g], axis=-1)
        return results


@PIPELINES.register_module()
class RandomGaussianBlur:
    """Random gaussian blur (reference augmentations.py:1224-1255, PIL
    GaussianBlur with radius ~ U(0.1, 2.0))."""

    def __init__(self, p=0.5, sigma_range=(0.1, 2.0), same_on_clip=True,
                 same_across_clip=True):
        self.p = p
        self.sigma_range = sigma_range
        self.same_on_clip = same_on_clip
        self.same_across_clip = same_across_clip

    def __call__(self, results):
        import cv2
        def sample():
            if np.random.rand() >= self.p:
                return None
            return np.random.uniform(*self.sigma_range)
        sigma = sample()
        for i in range(len(results['imgs'])):
            if _should_generate_new(
                    i, results, self.same_on_clip, self.same_across_clip,
                    None, None):
                sigma = sample()
            if sigma is not None:
                results['imgs'][i] = cv2.GaussianBlur(
                    results['imgs'][i], (0, 0), sigma)
        return results


@PIPELINES.register_module()
class CenterCrop:
    """Center crop (reference augmentations.py:798-868)."""

    def __init__(self, crop_size):
        self.crop_size = (crop_size, crop_size) if isinstance(
            crop_size, int) else tuple(crop_size)

    def __call__(self, results):
        img_h, img_w = results['img_shape']
        crop_w, crop_h = self.crop_size
        left = (img_w - crop_w) // 2
        top = (img_h - crop_h) // 2
        right, bottom = left + crop_w, top + crop_h
        results['imgs'] = [img[top:bottom, left:right]
                           for img in results['imgs']]
        results['crop_bbox'] = np.array([left, top, right, bottom])
        results['img_shape'] = (bottom - top, right - left)
        return results


@PIPELINES.register_module()
class RandomCrop:
    """Fixed-size random crop (reference augmentations.py:97-170)."""

    def __init__(self, size):
        self.size = size

    def __call__(self, results):
        img_h, img_w = results['img_shape']
        size = self.size
        assert size <= img_h and size <= img_w
        y_offset = np.random.randint(0, img_h - size + 1)
        x_offset = np.random.randint(0, img_w - size + 1)
        results['imgs'] = [
            img[y_offset:y_offset + size, x_offset:x_offset + size]
            for img in results['imgs']
        ]
        results['crop_bbox'] = np.array(
            [x_offset, y_offset, x_offset + size, y_offset + size])
        results['img_shape'] = (size, size)
        return results


@PIPELINES.register_module()
class MultiScaleCrop:
    """TSN-style multi-scale crop from fixed positions (reference
    augmentations.py:338-487)."""

    def __init__(self, input_size, scales=(1,), max_wh_scale_gap=1,
                 random_crop=False, num_fixed_crops=5):
        self.input_size = (input_size, input_size) if isinstance(
            input_size, int) else tuple(input_size)
        self.scales = scales
        self.max_wh_scale_gap = max_wh_scale_gap
        self.random_crop = random_crop
        self.num_fixed_crops = num_fixed_crops

    def __call__(self, results):
        img_h, img_w = results['img_shape']
        base_size = min(img_h, img_w)
        crop_sizes = [int(base_size * s) for s in self.scales]
        candidates = []
        for i, h in enumerate(crop_sizes):
            for j, w in enumerate(crop_sizes):
                if abs(i - j) <= self.max_wh_scale_gap:
                    candidates.append([w, h])
        # reference draw order + the snap-to-input within 3px
        # (augmentations.py:409-413); parity-tested draw-for-draw
        crop_size = random.choice(candidates)
        for i in range(2):
            if abs(crop_size[i] - self.input_size[i]) < 3:
                crop_size[i] = self.input_size[i]
        crop_w, crop_h = crop_size
        if self.random_crop:
            x_offset = random.randint(0, img_w - crop_w)
            y_offset = random.randint(0, img_h - crop_h)
        else:
            w_step = (img_w - crop_w) // 4
            h_step = (img_h - crop_h) // 4
            positions = [(0, 0), (4 * w_step, 0), (0, 4 * h_step),
                         (4 * w_step, 4 * h_step), (2 * w_step, 2 * h_step)]
            if self.num_fixed_crops == 13:
                positions += [(0, 2 * h_step), (4 * w_step, 2 * h_step),
                              (2 * w_step, 4 * h_step), (2 * w_step, 0),
                              (1 * w_step, 1 * h_step),
                              (3 * w_step, 1 * h_step),
                              (1 * w_step, 3 * h_step),
                              (3 * w_step, 3 * h_step)]
            x_offset, y_offset = random.choice(positions)
        results['imgs'] = [
            img[y_offset:y_offset + crop_h, x_offset:x_offset + crop_w]
            for img in results['imgs']
        ]
        results['crop_bbox'] = np.array(
            [x_offset, y_offset, x_offset + crop_w, y_offset + crop_h])
        results['img_shape'] = (crop_h, crop_w)
        results['scales'] = self.scales
        return results


@PIPELINES.register_module()
class ThreeCrop:
    """Three crops along the longer side (reference
    augmentations.py:868-939); triples the frame count."""

    def __init__(self, crop_size):
        self.crop_size = (crop_size, crop_size) if isinstance(
            crop_size, int) else tuple(crop_size)

    def __call__(self, results):
        img_h, img_w = results['img_shape']
        crop_w, crop_h = self.crop_size
        assert crop_h == img_h or crop_w == img_w
        if crop_h == img_h:
            w_step = (img_w - crop_w) // 2
            offsets = [(0, 0), (2 * w_step, 0), (w_step, 0)]
        else:
            h_step = (img_h - crop_h) // 2
            offsets = [(0, 0), (0, 2 * h_step), (0, h_step)]
        cropped = []
        for x, y in offsets:
            cropped.extend(
                [img[y:y + crop_h, x:x + crop_w]
                 for img in results['imgs']])
        results['imgs'] = cropped
        results['img_shape'] = (crop_h, crop_w)
        results['num_clips'] = results['num_clips'] * 3
        return results


@PIPELINES.register_module()
class TenCrop:
    """Four corners + center, flipped and not (reference
    augmentations.py:939-1008); 10x the frame count."""

    def __init__(self, crop_size):
        self.crop_size = (crop_size, crop_size) if isinstance(
            crop_size, int) else tuple(crop_size)

    def __call__(self, results):
        img_h, img_w = results['img_shape']
        crop_w, crop_h = self.crop_size
        w_step = (img_w - crop_w) // 4
        h_step = (img_h - crop_h) // 4
        offsets = [(0, 0), (4 * w_step, 0), (0, 4 * h_step),
                   (4 * w_step, 4 * h_step), (2 * w_step, 2 * h_step)]
        cropped = []
        for x, y in offsets:
            crops = [img[y:y + crop_h, x:x + crop_w]
                     for img in results['imgs']]
            flipped = [np.flip(c, axis=1).copy() for c in crops]
            cropped.extend(crops)
            cropped.extend(flipped)
        results['imgs'] = cropped
        results['img_shape'] = (crop_h, crop_w)
        results['num_clips'] = results['num_clips'] * 10
        return results


@PIPELINES.register_module()
class RGB2LAB:
    """RGB -> LAB color space (reference augmentations.py:1075-1086)."""

    def __call__(self, results):
        import cv2
        results['imgs'] = [
            cv2.cvtColor(img, cv2.COLOR_RGB2LAB)
            for img in results['imgs']
        ]
        return results


@PIPELINES.register_module()
class PhotoMetricDistortion:
    """Random brightness/contrast/saturation/hue distortion (reference
    augmentations.py:1087-1224)."""

    def __init__(self, brightness_delta=32, contrast_range=(0.5, 1.5),
                 saturation_range=(0.5, 1.5), hue_delta=18):
        self.brightness_delta = brightness_delta
        self.contrast_lower, self.contrast_upper = contrast_range
        self.saturation_lower, self.saturation_upper = saturation_range
        self.hue_delta = hue_delta

    def __call__(self, results):
        import cv2
        out = []
        for img in results['imgs']:
            img = img.astype(np.float32)
            if np.random.randint(2):
                img += np.random.uniform(-self.brightness_delta,
                                         self.brightness_delta)
            mode = np.random.randint(2)
            if mode == 1 and np.random.randint(2):
                img *= np.random.uniform(self.contrast_lower,
                                         self.contrast_upper)
            hsv = cv2.cvtColor(np.clip(img, 0, 255).astype(np.uint8),
                               cv2.COLOR_RGB2HSV).astype(np.float32)
            if np.random.randint(2):
                hsv[..., 1] *= np.random.uniform(self.saturation_lower,
                                                 self.saturation_upper)
            if np.random.randint(2):
                hsv[..., 0] = (hsv[..., 0] + np.random.uniform(
                    -self.hue_delta, self.hue_delta)) % 180
            img = cv2.cvtColor(
                np.clip(hsv, 0, [179, 255, 255]).astype(np.uint8),
                cv2.COLOR_HSV2RGB).astype(np.float32)
            if mode == 0 and np.random.randint(2):
                img *= np.random.uniform(self.contrast_lower,
                                         self.contrast_upper)
            out.append(np.clip(img, 0, 255).astype(np.uint8))
        results['imgs'] = out
        return results


@PIPELINES.register_module()
class RandomErasing:
    """Random rectangle erase per frame (reference
    augmentations.py:1478-1530)."""

    def __init__(self, p=0.5, area_range=(0.02, 0.33),
                 aspect_range=(0.3, 3.3), fill=0):
        self.p = p
        self.area_range = area_range
        self.aspect_range = aspect_range
        self.fill = fill

    def __call__(self, results):
        out = []
        for img in results['imgs']:
            if np.random.rand() < self.p:
                img = img.copy()
                h, w = img.shape[:2]
                area = h * w * np.random.uniform(*self.area_range)
                aspect = np.random.uniform(*self.aspect_range)
                eh = min(h, int(round(np.sqrt(area * aspect))))
                ew = min(w, int(round(np.sqrt(area / aspect))))
                y = np.random.randint(0, h - eh + 1)
                x = np.random.randint(0, w - ew + 1)
                img[y:y + eh, x:x + ew] = self.fill
            out.append(img)
        results['imgs'] = out
        return results


@PIPELINES.register_module()
class Grid:
    """Attach per-frame coordinate grids (reference
    augmentations.py:1322-1344)."""

    def __init__(self, normalize=False):
        self.normalize = normalize

    def __call__(self, results):
        h, w = results['original_shape']
        ys, xs = np.meshgrid(np.arange(h, dtype=np.float32),
                             np.arange(w, dtype=np.float32), indexing='ij')
        if self.normalize:
            ys = ys / max(h - 1, 1)
            xs = xs / max(w - 1, 1)
        grid = np.stack([xs, ys], axis=-1)
        results['grids'] = [grid.copy() for _ in range(len(results['imgs']))]
        return results


@PIPELINES.register_module()
class Image2Patch:
    """Split each frame into patches, treated as extra frames (reference
    augmentations.py:1346-1365)."""

    def __init__(self, patch_size, stride=None, scale_jitter=(0.7, 0.9)):
        self.patch_size = patch_size
        self.stride = stride if stride is not None else patch_size
        self.scale_jitter = scale_jitter

    def __call__(self, results):
        patches = []
        for img in results['imgs']:
            h, w = img.shape[:2]
            for y in range(0, h - self.patch_size + 1, self.stride):
                for x in range(0, w - self.patch_size + 1, self.stride):
                    patches.append(
                        img[y:y + self.patch_size, x:x + self.patch_size])
        num_patches_per_img = len(patches) // max(len(results['imgs']), 1)
        results['imgs'] = patches
        results['num_clips'] *= num_patches_per_img
        results['img_shape'] = (self.patch_size, self.patch_size)
        return results


@PIPELINES.register_module()
class HidePatch:
    """Randomly zero square patches (reference augmentations.py:1367-1389)."""

    def __init__(self, patch_size, hide_prob):
        self.patch_size = patch_size
        self.hide_prob = hide_prob

    def __call__(self, results):
        ps = self.patch_size
        if isinstance(ps, (list, tuple)):
            ps = int(np.random.choice(ps))
        if ps == 0:
            return results
        h, w = results['imgs'][0].shape[:2]
        for i, img in enumerate(results['imgs']):
            img = img.copy()
            for y in range(0, h, ps):
                for x in range(0, w, ps):
                    if np.random.rand() < self.hide_prob:
                        img[y:y + ps, x:x + ps] = 0
            results['imgs'][i] = img
        return results


@PIPELINES.register_module()
class RandomAffine:
    """Random affine warp with per-frame re-randomization (reference
    augmentations.py:1391-1443)."""

    def __init__(self, degrees=10, translate=(0.1, 0.1), scale=(0.9, 1.1),
                 shear=5, same_on_clip=True, same_across_clip=True):
        self.degrees = degrees
        self.translate = translate
        self.scale = scale
        self.shear = shear
        self.same_on_clip = same_on_clip
        self.same_across_clip = same_across_clip

    def _sample(self, h, w):
        import cv2
        angle = np.random.uniform(-self.degrees, self.degrees)
        tx = np.random.uniform(-self.translate[0], self.translate[0]) * w
        ty = np.random.uniform(-self.translate[1], self.translate[1]) * h
        s = np.random.uniform(*self.scale)
        mat = cv2.getRotationMatrix2D((w / 2, h / 2), angle, s)
        mat[0, 2] += tx
        mat[1, 2] += ty
        return mat

    def __call__(self, results):
        import cv2
        h, w = results['imgs'][0].shape[:2]
        mat = self._sample(h, w)
        for i, img in enumerate(results['imgs']):
            if _should_generate_new(
                    i, results, self.same_on_clip, self.same_across_clip,
                    None, None):
                mat = self._sample(h, w)
            results['imgs'][i] = cv2.warpAffine(img, mat, (w, h))
        return results


@PIPELINES.register_module()
class RandomChoiceRotate:
    """Rotate by one of ``degrees`` with prob p; emits rotation labels
    (reference augmentations.py:1445-1476)."""

    def __init__(self, p, degrees=(90, 180, 270), same_on_clip=True,
                 same_across_clip=True):
        self.p = p
        self.degrees = list(degrees)
        self.same_on_clip = same_on_clip
        self.same_across_clip = same_across_clip

    def _sample(self):
        if np.random.rand() < self.p:
            return int(np.random.choice(len(self.degrees))) + 1
        return 0

    def __call__(self, results):
        import cv2
        labels = []
        choice = self._sample()
        for i, img in enumerate(results['imgs']):
            if _should_generate_new(
                    i, results, self.same_on_clip, self.same_across_clip,
                    None, None):
                choice = self._sample()
            if choice > 0:
                h, w = img.shape[:2]
                mat = cv2.getRotationMatrix2D(
                    (w / 2, h / 2), self.degrees[choice - 1], 1.0)
                results['imgs'][i] = cv2.warpAffine(img, mat, (w, h))
            labels.append(choice)
        results['rotation_labels'] = np.array(labels)
        return results


@PIPELINES.register_module()
class MultiGroupCrop:
    """``groups`` independent random crops of the whole clip, concatenated
    along the frame axis (reference augmentations.py:1008-1072)."""

    def __init__(self, crop_size, groups):
        self.crop_size = (crop_size, crop_size) if isinstance(
            crop_size, int) else tuple(crop_size)
        if not isinstance(groups, int) or groups <= 0:
            raise ValueError(f'groups must be a positive int, got {groups}')
        self.groups = groups

    def __call__(self, results):
        imgs = results['imgs']
        img_h, img_w = imgs[0].shape[:2]
        crop_w, crop_h = self.crop_size
        crops, bboxes = [], []
        for _ in range(self.groups):
            left = np.random.randint(0, img_w - crop_w + 1)
            top = np.random.randint(0, img_h - crop_h + 1)
            bbox = [left, top, left + crop_w, top + crop_h]
            crops.extend(img[top:top + crop_h, left:left + crop_w]
                         for img in imgs)
            bboxes.extend([bbox] * len(imgs))
        results['imgs'] = crops
        results['crop_bbox'] = np.array(bboxes)
        results['img_shape'] = crops[0].shape[:2]
        return results


@PIPELINES.register_module()
class Fuse:
    """Config-compatibility no-op (reference augmentations.py:53-94 resolves
    accumulated lazy crops and flips; every geometric step here applies
    eagerly, so there is nothing left to fuse)."""

    def __call__(self, results):
        if results.get('lazy'):
            raise RuntimeError('lazy pipeline steps are not supported; '
                               'every step applies eagerly')
        return results


@PIPELINES.register_module()
class DeviceAug:
    """Host side of on-device augmentation (``vfs_tpu_torch.ops.device_aug``):
    resize the decoded frames to a fixed uint8 staging size (cv2
    ``INTER_LINEAR``), stack them as ``(num_clips, clip_len, Hs, Ws, C)``
    and record the original frame size as ``orig_hw`` (the device samples
    its crops in original coordinates). The crop, flip, jitter, grayscale,
    blur and normalisation of the host pipeline move into
    ``cfg.device_aug`` and run in the train step."""

    def __init__(self, scale=(320, 256)):
        self.scale = tuple(scale)  # (W, H), Resize convention

    def __call__(self, results):
        import cv2
        imgs = results['imgs']
        orig_hw = np.asarray(imgs[0].shape[:2], np.int32)
        w, h = self.scale
        if imgs[0].shape[:2] != (h, w):
            imgs = [cv2.resize(im, (w, h), interpolation=cv2.INTER_LINEAR)
                    for im in imgs]
        arr = np.stack(imgs).astype(np.uint8)
        n = int(results.get('num_clips', 1))
        results['imgs'] = arr.reshape(n, len(imgs) // n, h, w, arr.shape[-1])
        results['orig_hw'] = orig_hw
        return results
