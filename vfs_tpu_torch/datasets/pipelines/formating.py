"""Output formatting of the pipelines (counterpart of
``vfs_tpu/datasets/pipelines/formating.py``; reference:
mmaction/datasets/pipelines/formating.py).

Layout note: the reference's ``FormatShape('NCTHW')`` produces
(N_clips, C, T, H, W) tensors; the port keeps the JAX package's
channels-last layout at its public seams, so the same config key produces
``(N_clips, T, H, W, C)`` numpy arrays, which ``VanillaTracker`` takes."""

from __future__ import annotations

import numpy as np

from ..registry import PIPELINES


@PIPELINES.register_module()
class FormatShape:
    """Reshape the flat (M, H, W, C) frame stack into clips."""

    def __init__(self, input_format):
        if input_format not in ('NCTHW', 'NTHWC', 'NCHW', 'NHWC'):
            raise ValueError(f'input_format {input_format} invalid')
        self.input_format = input_format

    def __call__(self, results):
        imgs = results['imgs']
        if isinstance(imgs, list):
            imgs = np.stack(imgs)
        if self.input_format in ('NCTHW', 'NTHWC'):
            # (M, H, W, C) -> (num_clips, clip_len, H, W, C)
            imgs = imgs.reshape((results['num_clips'], results['clip_len'])
                                + imgs.shape[1:])
        results['imgs'] = imgs
        results['input_shape'] = imgs.shape
        return results


@PIPELINES.register_module()
class Collect:
    """Collect ``keys`` plus an ``img_meta`` dict of ``meta_keys``
    (reference formating.py:145-218; plain dicts, no DataContainer). The
    normalisation parameters always travel in the meta, so the tracker can
    normalise uint8 frames on the card."""

    def __init__(self, keys, meta_keys=('frame_dir', 'frame_inds',
                                        'original_shape', 'seg_map')):
        self.keys = keys
        self.meta_keys = meta_keys

    def __call__(self, results):
        data = {}
        if len(self.meta_keys) != 0:
            meta = {k: results[k] for k in self.meta_keys if k in results}
            if 'img_norm_cfg' in results:
                meta.setdefault('img_norm_cfg', results['img_norm_cfg'])
            data['img_meta'] = meta
        for key in self.keys:
            data[key] = results[key]
        return data


@PIPELINES.register_module()
class ToTensor:
    """Numpy passthrough kept for config compatibility: the tracker moves
    the frames to the card itself (pinned, on a side stream)."""

    def __init__(self, keys):
        self.keys = keys

    def __call__(self, results):
        for key in self.keys:
            results[key] = np.asarray(results[key])
        return results


@PIPELINES.register_module()
class Transpose:

    def __init__(self, keys, order):
        self.keys = keys
        self.order = order

    def __call__(self, results):
        for key in self.keys:
            results[key] = np.transpose(results[key], self.order)
        return results


@PIPELINES.register_module()
class ImageToTensor:
    """Materialise image keys as contiguous arrays. The reference
    (formating.py:89-112) transposes HWC to CHW; the port keeps the
    channels-last layout at its seams, so the layout stays HWC."""

    def __init__(self, keys):
        self.keys = keys

    def __call__(self, results):
        for key in self.keys:
            results[key] = np.ascontiguousarray(results[key])
        return results


@PIPELINES.register_module()
class ToDataContainer:
    """Config-compatibility no-op (reference formating.py:59-88 wraps
    fields in mmcv's DataContainer for its collate; the port collates
    plain numpy dicts, so the fields pass through)."""

    def __init__(self, fields=None):
        self.fields = fields

    def __call__(self, results):
        return results

