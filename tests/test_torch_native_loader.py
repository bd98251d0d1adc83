"""The port's native decoders (``vfs_tpu_torch.datasets.native_loader`` and
the decode steps of ``datasets/pipelines/loading.py``) against the JAX
package's on the same files, on the CPU: every buffer bit-equal, as
tests/test_data/{test_native_loader,test_video_decode,test_yuv_decode}.py
hold the JAX loader. The JAX loader builds its libraries next to its own
sources; here it builds them into a temporary directory instead
(``jax_loader``), so nothing is written under ``vfs_tpu/native/``. Skipped
only where ``g++`` is absent, as the JAX tests skip."""

import filecmp
import logging
import os.path as osp
import shutil
import threading

import numpy as np
import pytest
import torch

from vfs_tpu.datasets import build_dataloader as jax_build_dataloader
from vfs_tpu.datasets import build_dataset as jax_build_dataset
from vfs_tpu.datasets.registry import PIPELINES as JAX_PIPELINES
from vfs_tpu_torch.datasets import build_dataloader, build_dataset
from vfs_tpu_torch.datasets import native_loader
from vfs_tpu_torch.datasets.registry import PIPELINES
from vfs_tpu_torch.ops.yuv import Yuv420Frames

torch.set_num_threads(1)

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
pytestmark = pytest.mark.skipif(shutil.which('g++') is None,
                                reason='g++ unavailable')


@pytest.fixture(scope='module')
def jax_loader(tmp_path_factory):
    """``vfs_tpu.datasets.native_loader`` with its two libraries built from
    its own sources into a temporary directory."""
    from vfs_tpu.datasets import native_loader as jnl
    d = tmp_path_factory.mktemp('jax_native')
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnl, '_SO', str(d / 'libframe_loader.so'))
        mp.setattr(jnl, '_VSO', str(d / 'libvideo_decoder.so'))
        mp.setattr(jnl, '_lib', None)
        mp.setattr(jnl, '_vlib', None)
        assert jnl.get_lib() is not None and jnl.get_video_lib() is not None
        yield jnl


def _smooth_frames(t, h, w, seed):
    """Smooth colour gradients (tests/test_data/test_yuv_decode.py)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    frames = []
    for i in range(t):
        chans = [127 + 80 * np.sin(2 * np.pi *
                                   (rng.uniform(0.3, 1.0) * yy / h +
                                    rng.uniform(0.3, 1.0) * xx / w) + 0.2 * i)
                 for _ in range(3)]
        frames.append(np.stack(chans, -1))
    return np.clip(np.stack(frames), 0, 255).astype(np.uint8)


@pytest.fixture(scope='module')
def jpegs(tmp_path_factory):
    """Four 48x64 JPEGs named ``{:05d}.jpg`` from 1, with a palette PNG of
    the first frame."""
    from PIL import Image
    d = tmp_path_factory.mktemp('jpegs')
    imgs = _smooth_frames(4, 48, 64, seed=1)
    paths = []
    for i, f in enumerate(imgs):
        p = str(d / f'{i + 1:05d}.jpg')
        Image.fromarray(f).save(p, quality=95)
        paths.append(p)
    seg = np.zeros((48, 64), np.uint8)
    seg[10:30, 20:40] = 1
    Image.fromarray(seg).save(str(d / 'seg.png'))
    return paths


@pytest.fixture(scope='module')
def index_video(tmp_path_factory):
    """A 60-frame mp4v clip whose frame i is solid grey i*4 with a
    textured band (tests/test_data/test_video_decode.py's, plus texture)."""
    import cv2
    path = str(tmp_path_factory.mktemp('vid') / 'idx.mp4')
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*'mp4v'), 30, (64, 48))
    rng = np.random.RandomState(0)
    band = rng.randint(0, 255, (8, 64, 3), np.uint8)
    for i in range(60):
        frame = np.full((48, 64, 3), i * 4, np.uint8)
        frame[20:28] = np.roll(band, i, axis=1)
        w.write(frame)
    w.release()
    return path


def test_sources_are_the_jax_packages():
    """The port builds a byte-equal copy of the JAX package's JPEG loader,
    and of its video decoder but for the row fix (next test): every line
    of the JAX source is in the port's, in order. Nothing is built under
    ``vfs_tpu/native/``."""
    src = osp.join(ROOT, 'vfs_tpu_torch', 'csrc', 'native')
    ref = osp.join(ROOT, 'vfs_tpu', 'native')
    assert filecmp.cmp(osp.join(src, 'frame_loader.cpp'),
                       osp.join(ref, 'frame_loader.cpp'), shallow=False)
    with open(osp.join(src, 'video_decoder.cpp')) as f:
        ours = f.read().splitlines()
    with open(osp.join(ref, 'video_decoder.cpp')) as f:
        theirs = f.read().splitlines()
    changed = {'    uint8_t* dst_data[4] = {dst, nullptr, nullptr, nullptr};',
               '    int dst_linesize[4] = {out_w * 3, 0, 0, 0};',
               '  if (frame == nullptr || last_frame == nullptr || pkt == '
               'nullptr) {'}
    it = iter(ours)
    assert all(any(line == o for o in it) for line in theirs
               if line not in changed)
    assert len(ours) - len(theirs) < 40
    for name in ('frame_loader', 'video_decoder'):
        assert native_loader.library_path(name).parent == \
            native_loader.BUILD_DIR
    assert 'vfs_tpu/native' not in str(native_loader.BUILD_DIR)


def _raw_decode(lib, path, inds, hw, fill):
    """``vd_decode_indices`` into a buffer filled with ``fill``."""
    import ctypes
    inds = np.asarray(inds, np.int64)
    buf = np.full((len(inds), *hw, 3), fill, np.uint8)
    assert lib.vd_decode_indices(
        path.encode(), inds.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(inds), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        hw[0], hw[1]) == len(inds)
    return buf


def test_video_rows_written_whole_at_any_width(tmp_path, jax_loader):
    """At a width that is not a multiple of 16 (340, the Kinetics clips'),
    the JAX decoder leaves the last 4 columns of every frame unwritten
    (their bytes are whatever the buffer held; ROADMAP Queue 3). The
    port's writes every pixel: its frames equal cv2's bit for bit, and
    the JAX decoder's wherever that one writes."""
    import cv2
    path = str(tmp_path / 'w340.mp4')
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*'mp4v'), 25,
                             (340, 48))
    rng = np.random.RandomState(1)
    for _ in range(3):
        writer.write(rng.randint(0, 255, (48, 340, 3), np.uint8))
    writer.release()
    ours = [_raw_decode(native_loader.get_video_lib(), path, [0, 2],
                        (48, 340), fill) for fill in (0, 255)]
    theirs = [_raw_decode(jax_loader.get_video_lib(), path, [0, 2],
                          (48, 340), fill) for fill in (0, 255)]
    np.testing.assert_array_equal(ours[0], ours[1])
    cap = cv2.VideoCapture(path)
    ref = []
    for _ in range(3):
        ref.append(cv2.cvtColor(cap.read()[1], cv2.COLOR_BGR2RGB))
    cap.release()
    np.testing.assert_array_equal(ours[0], np.stack(ref)[[0, 2]])
    unwritten = theirs[0] != theirs[1]
    assert unwritten[..., 336:, :].all() and not unwritten[..., :336, :].any()
    np.testing.assert_array_equal(theirs[0][..., :336, :],
                                  ours[0][..., :336, :])


@pytest.mark.parametrize('out_hw', [None, (24, 32), (61, 90)],
                         ids=['native_size', 'down', 'up'])
def test_decode_jpeg_batch_equals_jax(jpegs, jax_loader, out_hw):
    import cv2
    ours = native_loader.decode_jpeg_batch(jpegs, out_hw=out_hw,
                                           num_threads=2)
    ref = jax_loader.decode_jpeg_batch(jpegs, out_hw=out_hw, num_threads=2)
    assert ours.shape == ((4, 48, 64, 3) if out_hw is None
                          else (4, *out_hw, 3))
    np.testing.assert_array_equal(ours, ref)
    if out_hw is None:  # libjpeg's RGB is cv2's, bit for bit
        for i, p in enumerate(jpegs):
            np.testing.assert_array_equal(ours[i], cv2.cvtColor(
                cv2.imread(p, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB))
    assert native_loader.probe_jpeg(jpegs[0]) == \
        jax_loader.probe_jpeg(jpegs[0]) == (48, 64)


def test_decode_jpeg_batch_yuv420_equals_jax(jpegs, jax_loader):
    ours = native_loader.decode_jpeg_batch_yuv420(jpegs, num_threads=3)
    ref = jax_loader.decode_jpeg_batch_yuv420(jpegs, num_threads=3)
    assert isinstance(ours, Yuv420Frames)
    assert ours.hw == ref.hw == (48, 64)
    assert ours.convention == ref.convention == 'jpeg'
    np.testing.assert_array_equal(np.asarray(ours), np.asarray(ref))


def test_missing_files_give_none(jpegs, index_video, jax_loader):
    missing = jpegs + [jpegs[0] + '.missing']
    assert native_loader.decode_jpeg_batch(missing) is None
    assert jax_loader.decode_jpeg_batch(missing) is None
    assert native_loader.decode_jpeg_batch_yuv420(missing) is None
    assert native_loader.probe_video(index_video + '.missing') is None
    assert native_loader.decode_video_indices(index_video + '.missing',
                                              [0]) is None


def test_probe_video_equals_jax(index_video, jax_loader):
    ours = native_loader.probe_video(index_video)
    assert ours == jax_loader.probe_video(index_video)
    assert ours[:3] == (60, 48, 64) and ours[3] == pytest.approx(30.0)


@pytest.mark.parametrize('inds,out_hw', [
    ([59, 0, 7, 7, 33], None),       # unordered, a repeat
    ([10, 200, 10], None),           # past the end: the last frame
    ([200, 300], None),              # all past the end
    ([3, 3, 41, 12], (24, 40)),      # resized by swscale
], ids=['unordered_repeat', 'past_eof', 'all_past_eof', 'resized'])
def test_decode_video_indices_equals_jax(index_video, jax_loader, inds,
                                         out_hw):
    ours = native_loader.decode_video_indices(index_video, inds, out_hw)
    ref = jax_loader.decode_video_indices(index_video, inds, out_hw)
    hw = out_hw or (48, 64)
    assert ours.shape == (len(inds), *hw, 3)
    np.testing.assert_array_equal(ours, ref)
    last = native_loader.decode_video_indices(index_video, [59], out_hw)[0]
    for i, want in enumerate(inds):
        if want >= 60:  # decord's clamp: the true last frame
            np.testing.assert_array_equal(ours[i], last)
        if inds.count(want) > 1:
            np.testing.assert_array_equal(ours[i], ours[inds.index(want)])
        if out_hw is None and want < 60:  # mp4v: within codec loss
            assert abs(int(np.median(ours[i][:16])) - 4 * want) <= 4


def _rawframe_results(jpegs, **extra):
    return dict(frame_dir=osp.dirname(jpegs[0]), filename_tmpl='{:05d}.jpg',
                frame_inds=np.array([1, 3, 2, 2]), **extra)


def _run_both(name, results, **kwargs):
    """The JAX step and the port's of ``name`` on copies of ``results``."""
    return [registry.get(name)(**kwargs)(dict(results))
            for registry in (JAX_PIPELINES, PIPELINES)]


def test_rawframe_decode_native_equals_jax(jpegs, jax_loader):
    seg = osp.join(osp.dirname(jpegs[0]), 'seg.png')
    a, b = _run_both('RawFrameDecode', _rawframe_results(jpegs, seg_map=seg),
                     decoding_backend='native', num_threads=2)
    cv2_out = PIPELINES.get('RawFrameDecode')()(_rawframe_results(jpegs))
    assert len(b['imgs']) == 4 and b['img_shape'] == a['img_shape']
    for x, y, z in zip(a['imgs'], b['imgs'], cv2_out['imgs']):
        np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(y, z)
    np.testing.assert_array_equal(a['ref_seg_map'], b['ref_seg_map'])
    for name in ('FrameSelector', 'RawFrameDecode'):
        assert PIPELINES.get(name)(decoding_backend='native').num_threads \
            == 8


def test_rawframe_decode_yuv420_default_equals_jax(jpegs, jax_loader):
    """``RawFrameDecodeYUV420()`` defaults to the native decoder, as the
    JAX package's does: the files' own planes in the 'jpeg' convention."""
    assert PIPELINES.get('RawFrameDecodeYUV420')().decoding_backend == \
        'native'
    a, b = _run_both('RawFrameDecodeYUV420', _rawframe_results(jpegs))
    assert isinstance(b['imgs'], Yuv420Frames)
    assert b['imgs'].convention == a['imgs'].convention == 'jpeg'
    assert b['imgs'].hw == a['imgs'].hw == b['img_shape'] == (48, 64)
    np.testing.assert_array_equal(np.asarray(a['imgs']),
                                  np.asarray(b['imgs']))
    for k in ('mean', 'std'):
        np.testing.assert_array_equal(a['img_norm_cfg'][k],
                                      b['img_norm_cfg'][k])


@pytest.mark.parametrize('init,decode', [('DecordInit', 'DecordDecode'),
                                         ('PyAVInit', 'PyAVDecode')])
def test_decord_steps_equal_jax(index_video, jax_loader, init, decode):
    outs = []
    for registry in (JAX_PIPELINES, PIPELINES):
        r = registry.get(init)()(dict(filename=index_video))
        assert r['video_reader'] == ('native', index_video, (48, 64))
        r['frame_inds'] = np.array([[4, 58], [4, 90]])
        outs.append(registry.get(decode)()(r))
    a, b = outs
    assert b['total_frames'] == a['total_frames'] == 60
    assert b['avg_fps'] == a['avg_fps']
    assert b['video_reader'] is None and b['original_shape'] == (48, 64)
    np.testing.assert_array_equal(np.stack(a['imgs']), np.stack(b['imgs']))


def test_native_decode_failure_after_native_init_raises(index_video,
                                                        monkeypatch):
    r = PIPELINES.get('DecordInit')()(dict(filename=index_video))
    r['frame_inds'] = np.array([0])
    monkeypatch.setattr(native_loader, 'decode_video_indices',
                        lambda *a, **k: None)
    with pytest.raises(IOError, match='native decode failed'):
        PIPELINES.get('DecordDecode')()(r)


@pytest.mark.parametrize('step', ['RawFrameDecode', 'RawFrameDecodeYUV420',
                                  'Decord'])
def test_unavailable_library_takes_cv2_in_both(jpegs, index_video,
                                               jax_loader, monkeypatch,
                                               step):
    """With the libraries unavailable, both packages decode with cv2 (the
    yuv420 step packs cv2's RGB in the 'studio' convention), with equal
    output."""
    for mod in (native_loader, jax_loader):
        monkeypatch.setattr(mod, 'get_lib', lambda: None)
        monkeypatch.setattr(mod, 'get_video_lib', lambda: None)
    if step == 'Decord':
        outs = []
        for registry in (JAX_PIPELINES, PIPELINES):
            r = registry.get('DecordInit')()(dict(filename=index_video))
            assert not isinstance(r['video_reader'], tuple)
            r['frame_inds'] = np.array([7, 2, 2])
            outs.append(registry.get('DecordDecode')()(r)['imgs'])
        np.testing.assert_array_equal(np.stack(outs[0]), np.stack(outs[1]))
        return
    kwargs = dict(decoding_backend='native') if step == 'RawFrameDecode' \
        else {}
    a, b = _run_both(step, _rawframe_results(jpegs), **kwargs)
    if step == 'RawFrameDecodeYUV420':
        assert b['imgs'].convention == a['imgs'].convention == 'studio'
    np.testing.assert_array_equal(np.asarray(np.stack(a['imgs'])),
                                  np.asarray(np.stack(b['imgs'])))


def test_k400_videodataset_batch_equals_jax(tmp_path, index_video,
                                            jax_loader):
    """A Kinetics-layout ``VideoDataset`` batch through the r18 config's
    decode steps (``DecordInit``, 8 one-frame clips in 2 clips of 4,
    ``DecordDecode``) and crops, in each package under the same seeds."""
    import random
    ann = tmp_path / 'list.txt'
    ann.write_text(f'{index_video} 0\n{index_video} 1\n')
    pipeline = [
        dict(type='DecordInit'),
        dict(type='SampleFrames', clip_len=1, frame_interval=0,
             num_clips=8, out_of_bound_opt='loop'),
        dict(type='Clip2Frame', clip_len=4),
        dict(type='DecordDecode'),
        dict(type='RandomResizedCrop', area_range=(0.2, 1.0),
             same_across_clip=False, same_on_clip=False),
        dict(type='Resize', scale=(32, 32), keep_ratio=False),
        dict(type='Flip', flip_ratio=0.5, same_across_clip=False,
             same_on_clip=False),
        dict(type='Normalize', mean=[123.675, 116.28, 103.53],
             std=[58.395, 57.12, 57.375], to_bgr=False),
        dict(type='FormatShape', input_format='NCTHW'),
        dict(type='Collect', keys=['imgs', 'label'], meta_keys=[]),
    ]
    batches = []
    for build, build_loader in ((jax_build_dataset, jax_build_dataloader),
                                (build_dataset, build_dataloader)):
        dataset = build(dict(type='VideoDataset', ann_file=str(ann),
                             data_prefix=None, pipeline=pipeline))
        loader = build_loader(dataset, videos_per_gpu=2, workers_per_gpu=0,
                              shuffle=False, drop_last=False, seed=0)
        np.random.seed(5)
        random.seed(5)
        batches.append(next(iter(loader)))
    a, b = batches
    assert b['imgs'].shape == (2, 2, 4, 32, 32, 3)
    np.testing.assert_array_equal(np.asarray(a['imgs']),
                                  np.asarray(b['imgs']))
    assert list(b['label']) == [0, 1]


def test_concurrent_builds_share_one_library(tmp_path, monkeypatch):
    """Builders racing on an empty build directory each write a temporary
    file and rename it into place: every one ends with the same complete
    library, and no temporary file is left."""
    monkeypatch.setattr(native_loader, 'BUILD_DIR', tmp_path)
    paths, errors = [], []

    def build():
        try:
            paths.append(native_loader._build('frame_loader'))
        except Exception as e:  # noqa: BLE001  (reported below)
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors and len(set(paths)) == 1
    assert [p.name for p in tmp_path.iterdir()] == [paths[0].name]
    import ctypes
    assert ctypes.CDLL(str(paths[0])).fl_probe


def test_build_failure_falls_back_with_one_warning(tmp_path, monkeypatch,
                                                   caplog, jpegs):
    """A library that cannot build (here a missing link library) makes the
    getter return None, logs one WARNING a process with the compiler's
    last line, and ``build_error`` gives it; the steps then decode with
    cv2."""
    monkeypatch.setattr(native_loader, 'BUILD_DIR', tmp_path)
    monkeypatch.setattr(native_loader, 'LINK', dict(
        native_loader.LINK, frame_loader=['-lno_such_library_xyz']))
    monkeypatch.setattr(native_loader, '_libs', {})
    monkeypatch.setattr(native_loader, '_errors', {})
    # caplog listens on the root logger: the package logger stops
    # propagating once an earlier test in this process has called
    # ``get_root_logger``, so let its records through here
    monkeypatch.setattr(logging.getLogger('vfs_tpu_torch'), 'propagate',
                        True)
    with caplog.at_level(logging.WARNING, logger=native_loader.__name__):
        assert native_loader.get_lib() is None
        assert native_loader.get_lib() is None
    warnings = [r for r in caplog.records if r.levelno == logging.WARNING]
    assert len(warnings) == 1
    assert 'no_such_library_xyz' in native_loader.build_error('frame_loader')
    assert native_loader.build_error('video_decoder') is None
    assert native_loader.decode_jpeg_batch(jpegs) is None
    out = PIPELINES.get('RawFrameDecodeYUV420')()(_rawframe_results(jpegs))
    assert out['imgs'].convention == 'studio'
    assert not list(tmp_path.iterdir())
