"""The port's train data path against the JAX package's: the samplers and
transforms under equal ``np.random`` / ``random`` seeds, the decoders,
``EpochSampler``'s index streams over epochs and shards, the loader, and
one batch of the whole train pipeline on ``make_video_dataset``
(``tests/test_models/test_simsiam_train.py``). All host-side numpy and
cv2 code copied with its draw order, so every comparison is exact.
"""

import copy
import os.path as osp
import random

import numpy as np
import pytest
import torch

from vfs_tpu.datasets import build_dataset as jax_build_dataset
from vfs_tpu.datasets.builder import DataLoader as JaxDataLoader
from vfs_tpu.datasets.builder import EpochSampler as JaxEpochSampler
from vfs_tpu.datasets.registry import PIPELINES as JAX_PIPELINES
from vfs_tpu_torch.datasets import (DataLoader, EpochSampler,
                                    build_dataloader, build_dataset, collate)
from vfs_tpu_torch.datasets.registry import PIPELINES

from test_models.test_simsiam_train import make_video_dataset

torch.set_num_threads(1)

NORM = dict(mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375])


def train_pipeline(init='OpenCVInit', decode='OpenCVDecode', photometric=(),
                   on_device=False):
    """The r18 config's train pipeline at a test size (4 one-frame clips
    grouped into 2 clips of 2, 32x32 crops), optionally with the
    photometric transforms of configs/r18_sgd_cos_100e_r2_1xNx8_k400.py."""
    return [
        dict(type=init),
        dict(type='SampleFrames', clip_len=1, frame_interval=0,
             num_clips=4, out_of_bound_opt='loop'),
        dict(type='Clip2Frame', clip_len=2),
        dict(type=decode),
        dict(type='RandomResizedCrop', area_range=(0.2, 1.0),
             same_on_clip=False, same_across_clip=False),
        dict(type='Resize', scale=(32, 32), keep_ratio=False),
        dict(type='Flip', flip_ratio=0.5, same_on_clip=False,
             same_across_clip=False),
        *photometric,
        dict(type='Normalize', on_device=on_device, **NORM),
        dict(type='FormatShape', input_format='NCTHW'),
        dict(type='Collect', keys=['imgs', 'label'], meta_keys=[]),
        dict(type='ToTensor', keys=['imgs', 'label']),
    ]


PHOTOMETRIC = (
    dict(type='ColorJitter', brightness=0.4, contrast=0.4, saturation=0.4,
         hue=0.1, p=0.8, same_on_clip=False, same_across_clip=False),
    dict(type='RandomGrayScale', p=0.3, same_on_clip=False,
         same_across_clip=False),
    dict(type='RandomGaussianBlur', p=0.5, same_on_clip=False,
         same_across_clip=False),
)


@pytest.fixture(scope='module')
def videos(tmp_path_factory):
    return make_video_dataset(str(tmp_path_factory.mktemp('videos')),
                              num_videos=4, num_frames=12, hw=(48, 64))


def _seed(seed):
    np.random.seed(seed)
    random.seed(seed)


def _both(cfg, results, seed):
    """Run the JAX transform and the port's on copies of ``results``
    under the same seeds."""
    outs = []
    for registry in (JAX_PIPELINES, PIPELINES):
        transform = registry.get(cfg['type'])(
            **{k: v for k, v in cfg.items() if k != 'type'})
        _seed(seed)
        outs.append(transform(copy.deepcopy(results)))
    return outs


def _assert_results_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], list):
            assert len(a[k]) == len(b[k])
            for x, y in zip(a[k], b[k]):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
        elif isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k])
        elif k != 'video_reader':
            assert a[k] == b[k], k


@pytest.mark.parametrize('cfg', [
    dict(type='SampleFrames', clip_len=1, frame_interval=0, num_clips=8),
    dict(type='SampleFrames', clip_len=4, frame_interval=2, num_clips=2,
         temporal_jitter=True),
    dict(type='SampleFrames', clip_len=3, frame_interval=3, num_clips=5,
         out_of_bound_opt='repeat_last'),
    dict(type='SampleFrames', clip_len=2, frame_interval=1, num_clips=3,
         test_mode=True, twice_sample=True),
], ids=['vfs', 'jitter', 'repeat_last', 'test_mode'])
@pytest.mark.parametrize('total', [5, 12, 40])
def test_sample_frames_matches_jax(cfg, total):
    for seed in range(3):
        a, b = _both(cfg, dict(total_frames=total, start_index=0), seed)
        _assert_results_equal(a, b)


def test_clip_regrouping_matches_jax():
    results = dict(num_clips=8, clip_len=1)
    for cfg in (dict(type='Clip2Frame', clip_len=4), dict(type='Frame2Clip')):
        a, b = _both(cfg, results, 0)
        _assert_results_equal(a, b)
        assert b['num_clips'] * b['clip_len'] == 8


@pytest.mark.parametrize('cfg', [
    dict(type='RandomResizedCrop', area_range=(0.2, 1.0),
         same_on_clip=False, same_across_clip=False),
    dict(type='RandomResizedCrop', same_clip_indices=(1,),
         same_on_clip=False),
    *PHOTOMETRIC,
    dict(type='ColorJitter', brightness=0.8, contrast=0.8, saturation=0.8,
         hue=0.2, p=1.0),
    dict(type='RandomGrayScale', p=0.8, same_across_clip=False),
    dict(type='RandomGaussianBlur', p=1.0, sigma_range=(0.5, 3.0),
         same_on_clip=False),
], ids=lambda c: c['type'])
def test_random_transforms_match_jax(cfg):
    rs = np.random.RandomState(0)
    imgs = [rs.randint(0, 255, (40, 56, 3), np.uint8) for _ in range(6)]
    results = dict(imgs=imgs, img_shape=(40, 56), clip_len=3, num_clips=2)
    for seed in range(4):
        a, b = _both(cfg, results, seed)
        _assert_results_equal(a, b)


@pytest.mark.parametrize('init,decode', [('OpenCVInit', 'OpenCVDecode'),
                                         ('DecordInit', 'DecordDecode')])
def test_video_decoders_match_jax(videos, init, decode):
    """Both packages decode with cv2 under the OpenCV names and with their
    native FFmpeg decoders under the decord names, with equal frames."""
    path = osp.join(osp.dirname(videos), 'vid1.mp4')
    inds = np.array([0, 5, 5, 11, 3, 40])  # past the end: the last frame
    outs = []
    for registry in (JAX_PIPELINES, PIPELINES):
        r = registry.get(init)()(dict(filename=path))
        assert r['total_frames'] == 12
        r['frame_inds'] = inds
        outs.append(registry.get(decode)()(r))
    a, b = outs
    assert len(b['imgs']) == 6 and b['img_shape'] == (48, 64)
    for x, y in zip(a['imgs'], b['imgs']):
        np.testing.assert_array_equal(x, y)
    with pytest.raises(IOError):
        PIPELINES.get(init)()(dict(filename=path + '.missing'))


@pytest.mark.parametrize('shuffle', [True, False])
@pytest.mark.parametrize('length,shards', [(10, 1), (10, 3), (7, 4),
                                           (16, 2)])
def test_epoch_sampler_matches_jax(length, shards, shuffle):
    streams = []
    for epoch in range(3):
        for shard in range(shards):
            a = JaxEpochSampler(length, shuffle, 5, shards, shard)
            b = EpochSampler(length, shuffle, 5, shards, shard)
            np.testing.assert_array_equal(a.indices(epoch),
                                          b.indices(epoch))
            streams.append(b.indices(epoch))
            assert len(b.indices(epoch)) == b.num_samples
    # every index of an epoch is on some shard (padding wraps)
    first = np.concatenate(streams[:shards])
    assert set(first.tolist()) == set(range(length))
    if shuffle:
        assert not np.array_equal(streams[0], streams[shards])


def test_whole_train_pipeline_batch_matches_jax(videos):
    """One batch of the train pipeline (photometric transforms included)
    through each package's RepeatDataset and loader (one thread, so the
    draws come in order), under the same seeds."""
    batches = []
    for build, loader_cls in ((jax_build_dataset, JaxDataLoader),
                              (build_dataset, DataLoader)):
        ds = build(dict(type='RepeatDataset', times=2, dataset=dict(
            type='VideoDataset', ann_file=videos,
            data_prefix=osp.dirname(videos),
            pipeline=train_pipeline('DecordInit', 'DecordDecode',
                                    PHOTOMETRIC))))
        assert len(ds) == 8
        loader = loader_cls(ds, batch_size=4, num_workers=1, drop_last=True,
                            seed=3, worker_type='thread')
        loader.set_epoch(1)
        _seed(11)
        batches.append(list(loader))
        loader.close()
    (a, b) = batches
    assert len(a) == len(b) == 2
    for x, y in zip(a, b):
        assert set(x) == set(y) == {'imgs', 'label'}
        assert y['imgs'].shape == (4, 2, 2, 32, 32, 3)
        assert y['imgs'].dtype == np.float32
        np.testing.assert_array_equal(x['imgs'], y['imgs'])
        np.testing.assert_array_equal(x['label'], y['label'])


def test_uint8_pipeline_and_collate(videos):
    ds = build_dataset(dict(type='VideoDataset', ann_file=videos,
                            data_prefix=osp.dirname(videos),
                            pipeline=train_pipeline(on_device=True)))
    samples = [ds[i] for i in range(3)]
    assert samples[0]['imgs'].dtype == np.uint8
    batch = collate(samples + [dict(imgs=np.zeros((1,), np.uint8),
                                    label=np.asarray(0))])
    assert isinstance(batch['imgs'], list)  # ragged stays a list
    batch = collate(samples)
    assert batch['imgs'].shape == (3, 2, 2, 32, 32, 3)
    np.testing.assert_array_equal(batch['label'], [0, 0, 0])


def test_process_workers_build_the_epoch(videos):
    """Spawned worker processes (seeded seed + ordinal) give every batch
    of the epoch, in order of the index stream, and stop on close."""
    ds = build_dataset(dict(type='RepeatDataset', times=2, dataset=dict(
        type='VideoDataset', ann_file=videos,
        data_prefix=osp.dirname(videos), pipeline=train_pipeline())))
    loader = build_dataloader(ds, videos_per_gpu=2, workers_per_gpu=2,
                              drop_last=True, seed=0,
                              worker_type='process')
    try:
        batches = list(loader)
        assert loader.worker_type == 'process'
        assert len(batches) == len(loader) == 4
        for b in batches:
            assert b['imgs'].shape == (2, 2, 2, 32, 32, 3)
            assert np.isfinite(b['imgs']).all()
    finally:
        loader.close()
    assert loader._pool is None
