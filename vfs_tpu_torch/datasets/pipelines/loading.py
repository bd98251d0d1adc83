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
    first-frame annotation into ``ref_seg_map`` (reference
    loading.py:977-1069): a palette PNG (``seg_map``, read with PIL), or,
    for JHMDB, ``(H, W, num_joints)`` float32 gaussian label maps drawn at
    the joints ``pose_coord`` ``(2, num_joints)`` with ``sigma``.

    ``decoding_backend='native'`` (the JAX package's C++ libjpeg pool)
    comes with a later slice of the port and raises
    ``NotImplementedError``."""

    def __init__(self, io_backend='disk', decoding_backend='cv2', **kwargs):
        assert io_backend == 'disk'
        if decoding_backend != 'cv2':
            raise NotImplementedError(
                f'decoding_backend={decoding_backend!r} is ported in a later '
                "slice; use 'cv2'")

    def __call__(self, results):
        import cv2
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
        if 'pose_coord' in results:
            pose_coord = results['pose_coord']
            num_poses = pose_coord.shape[1]
            height, width = imgs[0].shape[:2]
            pose_map = np.zeros((height, width, num_poses), np.float32)
            sigma = results['sigma']
            for j in range(num_poses):
                if sigma > 0:
                    draw_label_map(pose_map[:, :, j], pose_coord[:, j], sigma)
                else:
                    tx, ty = int(pose_coord[0, j]), int(pose_coord[1, j])
                    if 0 <= tx < width and 0 <= ty < height:
                        pose_map[ty, tx, j] = 1.0
            results['ref_seg_map'] = pose_map
        return results


def draw_label_map(img, pt, sigma):
    """Draw an unnormalised 2-D gaussian centred at ``pt`` (x, y) into
    ``img`` in place (reference loading.py:1077-1103, JHMDB pose
    propagation)."""
    ul = [int(pt[0] - 3 * sigma), int(pt[1] - 3 * sigma)]
    br = [int(pt[0] + 3 * sigma + 1), int(pt[1] + 3 * sigma + 1)]
    if (ul[0] >= img.shape[1] or ul[1] >= img.shape[0] or br[0] < 0
            or br[1] < 0):
        return img
    size = 6 * sigma + 1
    x = np.arange(0, size, 1, float)
    y = x[:, np.newaxis]
    x0 = y0 = size // 2
    g = np.exp(-((x - x0)**2 + (y - y0)**2) / (2 * sigma**2))
    g_x = max(0, -ul[0]), min(br[0], img.shape[1]) - ul[0]
    g_y = max(0, -ul[1]), min(br[1], img.shape[0]) - ul[1]
    img_x = max(0, ul[0]), min(br[0], img.shape[1])
    img_y = max(0, ul[1]), min(br[1], img.shape[0])
    img[img_y[0]:img_y[1], img_x[0]:img_x[1]] = \
        g[g_y[0]:g_y[1], g_x[0]:g_x[1]]
    return img
