"""Frame samplers and decoders of the eval pipeline (host-side numpy, cv2
and PIL; counterpart of the eval part of
``vfs_tpu/datasets/pipelines/loading.py``, reference:
mmaction/datasets/pipelines/loading.py)."""

from __future__ import annotations

import os.path as osp

import numpy as np

from ..registry import PIPELINES


@PIPELINES.register_module()
class SequentialSampleFrames:
    """All frames in order (eval; reference loading.py:432-452)."""

    def __init__(self, frame_interval=1):
        self.frame_interval = frame_interval

    def __call__(self, results):
        total_frames = results['total_frames']
        frame_inds = np.arange(0, total_frames, self.frame_interval)
        frame_inds += results.get('start_index', 0)
        results['frame_inds'] = frame_inds
        results['clip_len'] = total_frames
        results['frame_interval'] = self.frame_interval
        results['num_clips'] = 1
        return results


@PIPELINES.register_module()
class RawFrameDecode:
    """Load frames from a directory of JPEGs with cv2; also loads the
    first-frame annotation (a palette PNG, read with PIL) into
    ``ref_seg_map`` (reference loading.py:977-1069).

    ``decoding_backend='native'`` (the JAX package's C++ libjpeg pool) and
    the JHMDB pose maps (``pose_coord``) come with later slices of the
    port and raise ``NotImplementedError``."""

    def __init__(self, io_backend='disk', decoding_backend='cv2', **kwargs):
        assert io_backend == 'disk'
        if decoding_backend != 'cv2':
            raise NotImplementedError(
                f'decoding_backend={decoding_backend!r} is ported in a later '
                "slice; use 'cv2'")

    def __call__(self, results):
        import cv2
        if 'pose_coord' in results:
            raise NotImplementedError(
                'pose maps (JHMDB) are ported in a later slice')
        directory = results['frame_dir']
        filename_tmpl = results['filename_tmpl']
        offset = results.get('offset', 0)
        frame_inds = results['frame_inds']
        if frame_inds.ndim != 1:
            frame_inds = np.squeeze(frame_inds)
        imgs = []
        for frame_idx in frame_inds:
            frame_idx = int(frame_idx) + offset
            if 'frame_list' in results:
                filepath = osp.join(directory,
                                    results['frame_list'][frame_idx])
            else:
                filepath = osp.join(directory,
                                    filename_tmpl.format(frame_idx))
            img = cv2.imread(filepath, cv2.IMREAD_COLOR)
            if img is None:
                raise IOError(f'cannot read frame {filepath}')
            imgs.append(cv2.cvtColor(img, cv2.COLOR_BGR2RGB))
        results['imgs'] = imgs
        results['original_shape'] = imgs[0].shape[:2]
        results['img_shape'] = imgs[0].shape[:2]
        if 'seg_map' in results:
            # palette PNG: the index map (PIL, flag='unchanged' parity with
            # reference loading.py:1048-1054)
            from PIL import Image
            seg = np.asarray(Image.open(results['seg_map']))
            results['ref_seg_map'] = seg
            assert seg.shape[:2] == results['img_shape']
        return results
