"""Frame samplers and decoders (host-side numpy, cv2, PIL and the native
libjpeg / FFmpeg decoders of ``datasets.native_loader``; counterpart of
``vfs_tpu/datasets/pipelines/loading.py``, reference:
mmaction/datasets/pipelines/loading.py), and the temporal-localization
steps (features, labels, PGM proposals, SSN's proposal frames). The train
samplers draw from ``np.random`` in the JAX package's order, so equal
seeds give equal frames."""

from __future__ import annotations

import os.path as osp

import numpy as np

from ..registry import PIPELINES


@PIPELINES.register_module()
class SampleFrames:
    """Sample clips of ``clip_len`` frames (reference loading.py:17-190).

    Supports train (random offsets) and test (centered offsets) modes, the
    ``loop`` out-of-bound handling used by the VFS configs, and
    ``frame_interval=0`` (all frames of a clip at the same index; VFS r18
    config uses clip_len=1 so interval is irrelevant).
    """

    def __init__(self, clip_len, frame_interval=1, num_clips=1,
                 temporal_jitter=False, twice_sample=False,
                 out_of_bound_opt='loop', test_mode=False,
                 start_index=None):
        self.clip_len = clip_len
        self.frame_interval = frame_interval
        self.num_clips = num_clips
        self.temporal_jitter = temporal_jitter
        self.twice_sample = twice_sample
        self.out_of_bound_opt = out_of_bound_opt
        self.test_mode = test_mode
        self.start_index = start_index
        assert out_of_bound_opt in ('loop', 'repeat_last')

    def _get_train_clips(self, num_frames):
        # frame_interval=0 (the VFS configs) gives ori_clip_len=0 exactly
        # like the reference (loading.py:85): offsets can reach
        # num_frames and the 'loop' wrap brings them home — matching the
        # reference's sampling distribution draw-for-draw
        ori_clip_len = self.clip_len * self.frame_interval
        avg_interval = (num_frames - ori_clip_len + 1) // self.num_clips
        if avg_interval > 0:
            base_offsets = np.arange(self.num_clips) * avg_interval
            clip_offsets = base_offsets + np.random.randint(
                avg_interval, size=self.num_clips)
        elif num_frames > max(self.num_clips, ori_clip_len):
            clip_offsets = np.sort(
                np.random.randint(num_frames - ori_clip_len + 1,
                                  size=self.num_clips))
        elif avg_interval == 0:
            ratio = (num_frames - ori_clip_len + 1.0) / self.num_clips
            clip_offsets = np.around(np.arange(self.num_clips) * ratio)
        else:
            clip_offsets = np.zeros((self.num_clips,), np.int64)
        return clip_offsets

    def _get_test_clips(self, num_frames):
        ori_clip_len = self.clip_len * self.frame_interval
        avg_interval = (num_frames - ori_clip_len + 1) / float(self.num_clips)
        if num_frames > ori_clip_len - 1:
            base_offsets = np.arange(self.num_clips) * avg_interval
            clip_offsets = (base_offsets + avg_interval / 2.0).astype(np.int64)
            if self.twice_sample:
                clip_offsets = np.concatenate(
                    [clip_offsets, base_offsets.astype(np.int64)])
        else:
            clip_offsets = np.zeros((self.num_clips,), np.int64)
        return clip_offsets

    def __call__(self, results):
        total_frames = results['total_frames']
        if self.test_mode:
            clip_offsets = self._get_test_clips(total_frames)
        else:
            clip_offsets = self._get_train_clips(total_frames)
        if self.frame_interval == 0:
            frame_inds = np.repeat(clip_offsets[:, None], self.clip_len,
                                   axis=1)
        else:
            frame_inds = clip_offsets[:, None] + np.arange(
                self.clip_len)[None, :] * self.frame_interval
        frame_inds = np.concatenate(frame_inds)
        if self.temporal_jitter:
            perframe_offsets = np.random.randint(
                max(self.frame_interval, 1), size=len(frame_inds))
            frame_inds += perframe_offsets
        frame_inds = frame_inds.reshape((-1, self.clip_len))
        if self.out_of_bound_opt == 'loop':
            frame_inds = np.mod(frame_inds, max(total_frames, 1))
        else:
            safe_inds = frame_inds < total_frames
            unsafe_inds = 1 - safe_inds
            last_ind = np.max(safe_inds * frame_inds, axis=1)
            new_inds = (safe_inds * frame_inds +
                        (unsafe_inds.T * last_ind).T)
            frame_inds = new_inds
        start_index = self.start_index if self.start_index is not None \
            else results.get('start_index', 0)
        frame_inds = np.concatenate(frame_inds) + start_index
        results['frame_inds'] = frame_inds.astype(np.int64)
        results['clip_len'] = self.clip_len
        results['frame_interval'] = self.frame_interval
        results['num_clips'] = self.num_clips
        return results


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
class Frame2Clip:
    """Treat N sampled frames as one N-frame clip (loading.py:209-218)."""

    def __call__(self, results):
        results['clip_len'] = results['clip_len'] * results['num_clips']
        results['num_clips'] = 1
        return results


@PIPELINES.register_module()
class Clip2Frame:
    """Regroup K 1-frame clips into K/clip_len clips of clip_len frames
    (reference loading.py:221-233; the VFS r18 config samples 8 one-frame
    clips then groups them into 2 clips x 4 frames)."""

    def __init__(self, clip_len=2):
        self.clip_len = clip_len

    def __call__(self, results):
        assert results['num_clips'] % self.clip_len == 0
        results['num_clips'] = results['num_clips'] // self.clip_len
        results['clip_len'] = self.clip_len
        return results


@PIPELINES.register_module()
class OpenCVInit:
    """Open a video with cv2 (the reference uses decord,
    loading.py:801-838)."""

    def __init__(self, io_backend='disk', **kwargs):
        assert io_backend == 'disk'

    def __call__(self, results):
        import cv2
        cap = cv2.VideoCapture(results['filename'])
        if not cap.isOpened():
            raise IOError(f'cannot open video {results["filename"]}')
        results['video_reader'] = cap
        results['total_frames'] = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        return results


@PIPELINES.register_module()
class OpenCVDecode:
    """Decode the sampled ``frame_inds`` with cv2 (sequential seek; decodes
    each unique index once, like the reference's unique-index map,
    loading.py:855-876)."""

    def __call__(self, results):
        import cv2
        cap = results['video_reader']
        frame_inds = results['frame_inds']
        if frame_inds.ndim != 1:
            frame_inds = np.squeeze(frame_inds)
        unique_inds = np.unique(frame_inds)
        frames = {}
        # sequential decode up to max index (cv2 random seek is unreliable)
        max_ind = int(unique_inds.max())
        cap.set(cv2.CAP_PROP_POS_FRAMES, 0)
        idx = 0
        ok = True
        last = None
        while idx <= max_ind and ok:
            ok, frame = cap.read()
            if not ok:
                break
            last = frame
            if idx in unique_inds:
                frames[idx] = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            idx += 1
        if last is not None:
            for i in unique_inds:
                if int(i) not in frames:  # short video: repeat last frame
                    frames[int(i)] = cv2.cvtColor(last, cv2.COLOR_BGR2RGB)
        cap.release()
        results['video_reader'] = None
        imgs = [frames[int(i)] for i in frame_inds]
        results['imgs'] = imgs
        results['original_shape'] = imgs[0].shape[:2]
        results['img_shape'] = imgs[0].shape[:2]
        return results


@PIPELINES.register_module()
class DecordInit(OpenCVInit):
    """The reference's decord init (loading.py:801-838) on the native
    FFmpeg decoder (``datasets.native_loader``): container metadata only,
    no handle kept open, so loader processes share no decoder state. The
    reader is ``('native', filename, (h, w))``, with ``total_frames`` and
    ``avg_fps`` from the probe. Where the decoder cannot build or probe
    the file, the cv2 reader of ``OpenCVInit``."""

    def __init__(self, io_backend='disk', num_threads=1, **kwargs):
        super().__init__(io_backend=io_backend)
        self.num_threads = num_threads

    def __call__(self, results):
        from ..native_loader import probe_video
        probed = probe_video(results['filename'])
        if probed is None:
            return super().__call__(results)
        num_frames, height, width, fps = probed
        results['video_reader'] = ('native', results['filename'],
                                   (height, width))
        results['total_frames'] = num_frames
        results['avg_fps'] = fps
        return results


@PIPELINES.register_module()
class DecordDecode(OpenCVDecode):
    """The reference's decord ``get_batch`` (loading.py:840-880) on the
    native decoder: each unique index decoded once after a keyframe seek,
    gathered back to the sampled order. ``IOError`` if the native decode
    fails after a native init; the cv2 decode of ``OpenCVDecode`` after a
    cv2 init."""

    def __call__(self, results):
        reader = results.get('video_reader')
        if not (isinstance(reader, tuple) and reader[0] == 'native'):
            return super().__call__(results)
        from ..native_loader import decode_video_indices
        frame_inds = np.asarray(results['frame_inds']).reshape(-1)
        batch = decode_video_indices(reader[1], frame_inds, out_hw=reader[2])
        if batch is None:
            raise IOError(f'native decode failed for {reader[1]}')
        results['video_reader'] = None
        results['imgs'] = list(batch)
        results['original_shape'] = batch.shape[1:3]
        results['img_shape'] = batch.shape[1:3]
        return results


@PIPELINES.register_module()
class RawFrameDecode:
    """Load frames from a directory of JPEGs; also loads the first-frame
    annotation into ``ref_seg_map`` (reference loading.py:977-1069): a
    palette PNG (``seg_map``, read with PIL), or, for JHMDB, ``(H, W,
    num_joints)`` float32 gaussian label maps drawn at the joints
    ``pose_coord`` ``(2, num_joints)`` with ``sigma``.

    ``decoding_backend='native'`` decodes with the threaded libjpeg
    library of ``datasets.native_loader`` (``num_threads`` threads, the
    GIL released); it takes cv2's path for other files than ``.jpg`` /
    ``.jpeg`` and where the library is unavailable. Any other backend
    decodes with cv2, as in the JAX package."""

    def __init__(self, io_backend='disk', decoding_backend='cv2',
                 num_threads=8, **kwargs):
        assert io_backend == 'disk'
        self.decoding_backend = decoding_backend
        self.num_threads = num_threads

    @staticmethod
    def _paths(results):
        """The sampled frames' file paths."""
        directory = results['frame_dir']
        offset = results.get('offset', 0)
        frame_inds = results['frame_inds']
        if frame_inds.ndim != 1:
            frame_inds = np.squeeze(frame_inds)
        paths = []
        for frame_idx in frame_inds:
            frame_idx = int(frame_idx) + offset
            if 'frame_list' in results:
                paths.append(osp.join(directory,
                                      results['frame_list'][frame_idx]))
            else:
                paths.append(osp.join(
                    directory, results['filename_tmpl'].format(frame_idx)))
        return paths

    def _native(self, paths):
        return (self.decoding_backend == 'native' and paths
                and paths[0].lower().endswith(('.jpg', '.jpeg')))

    @staticmethod
    def _decode_cv2(paths):
        import cv2
        imgs = []
        for filepath in paths:
            img = cv2.imread(filepath, cv2.IMREAD_COLOR)
            if img is None:
                raise IOError(f'cannot read frame {filepath}')
            imgs.append(cv2.cvtColor(img, cv2.COLOR_BGR2RGB))
        return imgs

    def __call__(self, results):
        paths = self._paths(results)
        imgs = None
        if self._native(paths):
            from ..native_loader import decode_jpeg_batch
            batch = decode_jpeg_batch(paths, num_threads=self.num_threads)
            if batch is not None:
                imgs = list(batch)
        if imgs is None:
            imgs = self._decode_cv2(paths)
        results['imgs'] = imgs
        results['original_shape'] = imgs[0].shape[:2]
        results['img_shape'] = imgs[0].shape[:2]
        return self._load_labels(results, imgs[0].shape[:2])

    @staticmethod
    def _load_labels(results, hw):
        """The first-frame annotation into ``ref_seg_map``."""
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
            height, width = hw
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


@PIPELINES.register_module()
class RawFrameDecodeYUV420(RawFrameDecode):
    """Decode JPEG rawframes to flat planar I420, a ``Yuv420Frames`` (1.5
    bytes a pixel), for ``test_cfg.input_format='yuv420'`` (counterpart of
    the JAX class, ``vfs_tpu/datasets/pipelines/loading.py:359-420``). The
    eval path of videos already at their size: the card unpacks and
    normalises (``VanillaTracker.preload`` ships the array as it is), so
    ``mean`` / ``std`` take the host ``Normalize``'s place and no
    geometric transform may follow.

    ``decoding_backend='native'`` (the default, as in the JAX package)
    reads the files' own YCbCr 4:2:0 planes with libjpeg, convention
    ``'jpeg'`` (full range). Where the library is unavailable, and with
    any other backend, cv2 decodes RGB and ``ops.yuv.rgb_to_yuv420``
    packs it, convention ``'studio'``."""

    def __init__(self, io_backend='disk', decoding_backend='native',
                 num_threads=8, mean=(123.675, 116.28, 103.53),
                 std=(58.395, 57.12, 57.375), **kwargs):
        super().__init__(io_backend=io_backend,
                         decoding_backend=decoding_backend,
                         num_threads=num_threads, **kwargs)
        self.mean = np.array(mean, dtype=np.float32)
        self.std = np.array(std, dtype=np.float32)

    def __call__(self, results):
        from ...ops.yuv import Yuv420Frames, rgb_to_yuv420
        paths = self._paths(results)
        packed = None
        if self._native(paths):
            from ..native_loader import decode_jpeg_batch_yuv420
            packed = decode_jpeg_batch_yuv420(paths,
                                              num_threads=self.num_threads)
        if packed is None:
            rgb = np.stack(self._decode_cv2(paths))
            packed = Yuv420Frames(rgb_to_yuv420(rgb), rgb.shape[1:3],
                                  convention='studio')
        results['imgs'] = packed
        results['original_shape'] = packed.hw
        results['img_shape'] = packed.hw
        results['img_norm_cfg'] = dict(mean=self.mean, std=self.std,
                                       to_bgr=False)
        return self._load_labels(results, packed.hw)


@PIPELINES.register_module()
class DuplicateFrames:
    """Duplicate each clip ``times`` times (reference loading.py:190-206)."""

    def __init__(self, times=2):
        self.times = times

    def __call__(self, results):
        frame_inds = results['frame_inds'].reshape(-1, results['clip_len'])
        frame_inds = np.tile(frame_inds, (1, self.times)).reshape(-1)
        results['frame_inds'] = frame_inds
        results['num_clips'] *= self.times
        return results


@PIPELINES.register_module()
class DenseSampleFrames(SampleFrames):
    """Dense sampling within a 64-frame window (reference
    loading.py:343-430)."""

    def __init__(self, *args, sample_range=64, num_sample_positions=10,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.sample_range = sample_range
        self.num_sample_positions = num_sample_positions

    def _get_train_clips(self, num_frames):
        sample_position = max(1, 1 + num_frames - self.sample_range)
        interval = self.sample_range // self.num_clips
        start_idx = 0 if sample_position == 1 else np.random.randint(
            0, sample_position - 1)
        base_offsets = np.arange(self.num_clips) * interval
        return (base_offsets + start_idx) % num_frames

    def _get_test_clips(self, num_frames):
        sample_position = max(1, 1 + num_frames - self.sample_range)
        interval = self.sample_range // self.num_clips
        start_list = np.linspace(0, sample_position - 1,
                                 num=self.num_sample_positions, dtype=int)
        base_offsets = np.arange(self.num_clips) * interval
        clip_offsets = np.concatenate(
            [(base_offsets + start_idx) % num_frames
             for start_idx in start_list])
        return clip_offsets


@PIPELINES.register_module()
class UntrimmedSampleFrames:
    """Evenly spaced clips over an untrimmed video (reference
    loading.py:294-342)."""

    def __init__(self, clip_len=1, frame_interval=16, start_index=1):
        # unlike SampleFrames, the reference kept start_index a TRANSFORM
        # arg here, default 1 (loading.py:317) — not the dataset's value
        self.clip_len = clip_len
        self.frame_interval = frame_interval
        self.start_index = start_index

    def __call__(self, results):
        total_frames = results['total_frames']
        start_index = self.start_index
        clip_centers = np.arange(self.frame_interval // 2, total_frames,
                                 self.frame_interval)
        num_clips = clip_centers.shape[0]
        frame_inds = clip_centers[:, None] + np.arange(
            -(self.clip_len // 2), self.clip_len -
            (self.clip_len // 2))[None, :]
        frame_inds = np.clip(frame_inds, 0, total_frames - 1)
        frame_inds = np.concatenate(frame_inds) + start_index
        results['frame_inds'] = frame_inds.astype(np.int64)
        results['clip_len'] = self.clip_len
        results['frame_interval'] = self.frame_interval
        results['num_clips'] = num_clips
        return results


@PIPELINES.register_module()
class AppendFrames:
    """Append the first frames to pad short clips (reference
    loading.py:236-260)."""

    def __init__(self, num_append=1):
        self.num_append = num_append

    def __call__(self, results):
        frame_inds = results['frame_inds']
        results['frame_inds'] = np.concatenate(
            [frame_inds, frame_inds[:self.num_append]])
        results['clip_len'] += self.num_append
        return results


@PIPELINES.register_module()
class RawImageDecode:
    """Load a single image as a 1-frame video (reference
    loading.py:1105-1160)."""

    def __init__(self, io_backend='disk', **kwargs):
        assert io_backend == 'disk'

    def __call__(self, results):
        import cv2
        img = cv2.imread(results['filename'], cv2.IMREAD_COLOR)
        if img is None:
            raise IOError(f"cannot read {results['filename']}")
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        n = max(int(results.get('clip_len', 1)) *
                int(results.get('num_clips', 1)), 1)
        results['imgs'] = [img.copy() for _ in range(n)]
        results['original_shape'] = img.shape[:2]
        results['img_shape'] = img.shape[:2]
        results.setdefault('frame_inds', np.zeros(n, np.int64))
        results.setdefault('clip_len', 1)
        results.setdefault('num_clips', n)
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


# the reference's deprecated alias (loading.py:1164) and its PyAV names
# (loading.py:697-800): as in the JAX package, PyAV maps onto the native
# FFmpeg path, so they need no ``av``
@PIPELINES.register_module()
class FrameSelector(RawFrameDecode):
    pass


@PIPELINES.register_module()
class PyAVInit(DecordInit):
    pass


@PIPELINES.register_module()
class PyAVDecode(DecordDecode):
    pass


# --------------------------------------------------------------------------
# Temporal-action-localization data loading (BMN / TEM / PEM / SSN stack)
# --------------------------------------------------------------------------

@PIPELINES.register_module()
class LoadLocalizationFeature:
    """Load a per-video feature table for the localizers (reference
    loading.py:1174-1206).

    Reads ``{data_prefix}/{video_name}{ext}`` — a CSV with a header row and
    one row per temporal step — and stores it channels-first as
    ``results['raw_feature']`` of shape ``(C, T)``.
    """

    def __init__(self, raw_feature_ext='.csv'):
        if raw_feature_ext != '.csv':
            raise NotImplementedError(raw_feature_ext)
        self.raw_feature_ext = raw_feature_ext

    def __call__(self, results):
        path = osp.join(results['data_prefix'],
                        results['video_name'] + self.raw_feature_ext)
        table = np.loadtxt(path, dtype=np.float32, delimiter=',', skiprows=1)
        results['raw_feature'] = np.ascontiguousarray(table.T)
        return results


@PIPELINES.register_module()
class GenerateLocalizationLabels:
    """Normalize annotated segments to [0, 1] of the feature-covered
    duration (reference loading.py:1210-1242).

    The feature extractor typically covers only ``feature_frame`` of the
    video's ``duration_frame`` frames, so segment times are rescaled by the
    corrected duration ``feature_frame / duration_frame * duration_second``
    before clipping.
    """

    def __call__(self, results):
        corrected = (float(results['feature_frame']) /
                     results['duration_frame'] * results['duration_second'])
        bbox = [
            [np.clip(ann['segment'][0] / corrected, 0, 1),
             np.clip(ann['segment'][1] / corrected, 0, 1)]
            for ann in results['annotations']
        ]
        results['gt_bbox'] = np.array(bbox, dtype=np.float64)
        return results


@PIPELINES.register_module()
class LoadProposals:
    """Load PGM proposals + BSP features for PEM training (reference
    loading.py:1245-1313).

    Proposal CSVs have a header and columns
    ``tmin, tmax, tmin_score, tmax_score, score, match_iou`` (column 4 is
    unused); features are ``(num_proposals, D)`` ``.npy`` arrays. Only the
    first ``top_k`` rows of each are kept.
    """

    def __init__(self, top_k, pgm_proposals_dir, pgm_features_dir,
                 proposal_ext='.csv', feature_ext='.npy'):
        if proposal_ext != '.csv':
            raise NotImplementedError(proposal_ext)
        if feature_ext != '.npy':
            raise NotImplementedError(feature_ext)
        self.top_k = top_k
        self.pgm_proposals_dir = pgm_proposals_dir
        self.pgm_features_dir = pgm_features_dir
        self.proposal_ext = proposal_ext
        self.feature_ext = feature_ext

    def __call__(self, results):
        video_name = results['video_name']
        rows = np.loadtxt(
            osp.join(self.pgm_proposals_dir, video_name + self.proposal_ext),
            dtype=np.float32, delimiter=',', skiprows=1)
        rows = np.atleast_2d(rows)[:self.top_k]
        feats = np.load(
            osp.join(self.pgm_features_dir, video_name + self.feature_ext))
        results['bsp_feature'] = feats.astype(np.float32)[:self.top_k]
        results['tmin'] = rows[:, 0]
        results['tmax'] = rows[:, 1]
        results['tmin_score'] = rows[:, 2]
        results['tmax_score'] = rows[:, 3]
        results['reference_temporal_iou'] = rows[:, 5]
        return results


@PIPELINES.register_module()
class SampleProposalFrames:
    """Segment-wise frame sampling around SSN proposals (reference
    loading.py:455-695).

    Each proposal contributes three stages — ``aug_segments[0]`` starting
    segments drawn from the interval extended backwards by
    ``aug_ratio[0] * duration``, ``body_segments`` course segments inside
    the proposal, and ``aug_segments[1]`` ending segments extended forwards
    — with per-segment random offsets in train mode and centered offsets in
    val mode. Test mode ignores proposals and strides the whole video at
    ``test_interval``.

    Consumes ``results['out_proposals']`` as produced by
    ``SSNDataset`` (items ``((video_id, SSNInstance), type)``).

    The random offsets draw from ``rng`` (an ``np.random.RandomState``),
    by default from the global one, as the JAX package's step does.
    """

    def __init__(self, clip_len, body_segments, aug_segments, aug_ratio,
                 frame_interval=1, test_interval=6, temporal_jitter=False,
                 mode='train', rng=None):
        assert mode in ('train', 'val', 'test')
        self.rng = rng
        self.clip_len = clip_len
        self.body_segments = body_segments
        self.aug_segments = tuple(aug_segments)
        if isinstance(aug_ratio, (int, float)):
            aug_ratio = (aug_ratio, aug_ratio)
        self.aug_ratio = tuple(aug_ratio)
        assert len(self.aug_ratio) == 2
        self.frame_interval = frame_interval
        self.test_interval = test_interval
        self.temporal_jitter = temporal_jitter
        self.mode = mode

    def _random(self):
        return self.rng if self.rng is not None else np.random

    def _stage_offsets(self, valid_length, num_segments):
        """Offsets of ``num_segments`` clips inside a window of
        ``valid_length`` valid starting points (zeros when too short)."""
        if self.mode == 'train':
            avg = (valid_length + 1) // num_segments
            if avg > 0:
                return (np.arange(num_segments) * avg +
                        self._random().randint(avg, size=num_segments))
            return np.zeros((num_segments,), dtype=np.int64)
        if valid_length >= num_segments:
            avg = valid_length / float(num_segments)
            return (np.arange(num_segments) * avg + avg / 2.0).astype(
                np.int64)
        return np.zeros((num_segments,), dtype=np.int64)

    def _proposal_offsets(self, proposal, num_frames):
        start, end = proposal.start_frame, proposal.end_frame
        ori_clip_len = self.clip_len * self.frame_interval
        duration = end - start
        assert duration != 0
        valid_starting = max(
            0, start - int(duration * self.aug_ratio[0]))
        valid_ending = min(num_frames - ori_clip_len + 1,
                           end - 1 + int(duration * self.aug_ratio[1]))
        starting = self._stage_offsets(
            start - valid_starting - ori_clip_len,
            self.aug_segments[0]) + valid_starting
        course = self._stage_offsets(
            duration - ori_clip_len, self.body_segments) + start
        ending = self._stage_offsets(
            (valid_ending - end + 1) - ori_clip_len,
            self.aug_segments[1]) + end
        return np.concatenate([starting, course, ending])

    def __call__(self, results):
        total_frames = results['total_frames']
        ori_clip_len = self.clip_len * self.frame_interval
        if self.mode == 'test':
            clip_offsets = np.arange(0, total_frames - ori_clip_len,
                                     self.test_interval, dtype=np.int64)
        else:
            proposals = results['out_proposals']
            clip_offsets = np.concatenate([
                self._proposal_offsets(item[0][1], total_frames)
                for item in proposals]) if proposals else \
                np.zeros((0,), dtype=np.int64)
        frame_inds = (clip_offsets[:, None].astype(np.int64) +
                      np.arange(self.clip_len)[None] * self.frame_interval)
        frame_inds = np.concatenate(frame_inds)
        if self.temporal_jitter:
            frame_inds = frame_inds + self._random().randint(
                self.frame_interval, size=len(frame_inds))
        frame_inds = np.mod(frame_inds, total_frames) + \
            results['start_index']
        results['frame_inds'] = frame_inds.astype(np.int64)
        results['clip_len'] = self.clip_len
        results['frame_interval'] = self.frame_interval
        results['num_clips'] = (self.body_segments + self.aug_segments[0] +
                                self.aug_segments[1])
        if self.mode in ('train', 'val'):
            results['num_proposals'] = len(results['out_proposals'])
        return results
