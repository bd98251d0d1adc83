"""The recognition data path, inference and tools of the port against the
JAX package's: each new pipeline step
(``vfs_tpu/datasets/pipelines/{loading,augmentations,formating}.py``)
under one seed of ``np.random`` and ``random`` (equal frames, indices and
meta), ``ImageDataset`` and ``VideoDataset.evaluate``,
``inference_recognizer``'s top-k on the same weights, and
``report_accuracy``'s printed line. ``demo_recognition`` runs on the CPU
when asked and raises without a GPU otherwise.
"""

import copy
import io
import os
import os.path as osp
import random
import runpy
import sys
from contextlib import redirect_stdout

import cv2
import numpy as np
import pytest
import torch

from vfs_tpu.apis.inference import \
    inference_recognizer as jax_inference_recognizer
from vfs_tpu.datasets import PIPELINES as JAX_PIPELINES
from vfs_tpu.datasets import build_dataset as jax_build_dataset
from vfs_tpu.models import build_model as jax_build_model
from vfs_tpu.utils import Config as JaxConfig
from vfs_tpu_torch.apis import inference_recognizer, init_recognizer
from vfs_tpu_torch.checkpoint import flax_recognizer_to_torch
from vfs_tpu_torch.datasets import PIPELINES, build_dataset
from vfs_tpu_torch.tools import demo_recognition
from vfs_tpu_torch.tools.analysis import report_accuracy

from test_models.test_simsiam_train import make_video_dataset
from test_torch_recognition import jax_variables

torch.set_num_threads(1)

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
NORM = dict(mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375])


def _frames_results(n=6, hw=(40, 48), num_clips=None, clip_len=None):
    rng = np.random.RandomState(0)
    imgs = [rng.randint(0, 255, hw + (3,), np.uint8) for _ in range(n)]
    r = dict(imgs=imgs, img_shape=hw, original_shape=hw)
    if num_clips:
        r.update(num_clips=num_clips, clip_len=clip_len)
    return r


def _sample_results(total_frames, **extra):
    return dict(total_frames=total_frames, start_index=0, **extra)


def _sampled(total_frames=20, clip_len=2, num_clips=3):
    r = _sample_results(total_frames)
    r['frame_inds'] = np.arange(clip_len * num_clips) * 2
    r.update(clip_len=clip_len, num_clips=num_clips)
    return r


STEPS = [
    ('DenseSampleFrames', dict(clip_len=2, frame_interval=1, num_clips=4,
                               sample_range=16), lambda: _sample_results(40)),
    ('DenseSampleFrames', dict(clip_len=2, num_clips=4, sample_range=16),
     lambda: _sample_results(10)),
    ('DenseSampleFrames', dict(clip_len=2, num_clips=4, sample_range=16,
                               num_sample_positions=3, test_mode=True),
     lambda: _sample_results(40)),
    ('UntrimmedSampleFrames', dict(clip_len=3, frame_interval=4),
     lambda: _sample_results(30)),
    ('DuplicateFrames', dict(times=3), _sampled),
    ('AppendFrames', dict(num_append=2), _sampled),
    ('CenterCrop', dict(crop_size=24), _frames_results),
    ('CenterCrop', dict(crop_size=(32, 20)), _frames_results),
    ('RandomCrop', dict(size=20), _frames_results),
    ('MultiScaleCrop', dict(input_size=24, scales=(1, .875, .75, .66),
                            max_wh_scale_gap=1), _frames_results),
    ('MultiScaleCrop', dict(input_size=24, scales=(1, .875, .75, .66),
                            random_crop=True), _frames_results),
    ('MultiScaleCrop', dict(input_size=(24, 30), scales=(1, .8),
                            num_fixed_crops=13), _frames_results),
    ('ThreeCrop', dict(crop_size=(30, 40)),
     lambda: _frames_results(num_clips=2, clip_len=3)),
    ('ThreeCrop', dict(crop_size=(48, 20)),
     lambda: _frames_results(num_clips=2, clip_len=3)),
    ('TenCrop', dict(crop_size=20),
     lambda: _frames_results(num_clips=2, clip_len=3)),
    ('MultiGroupCrop', dict(crop_size=16, groups=3), _frames_results),
    ('Fuse', {}, _frames_results),
    ('ImageToTensor', dict(keys=['imgs']),
     lambda: dict(imgs=np.arange(24).reshape(2, 3, 4)[:, ::-1])),
    ('Transpose', dict(keys=['imgs'], order=[2, 0, 1]),
     lambda: dict(imgs=np.arange(24).reshape(2, 3, 4))),
    ('ToDataContainer', dict(fields=[dict(key='imgs')]),
     lambda: dict(imgs=np.zeros(3))),
]


def _assert_results_equal(ours, ref):
    assert set(ours) == set(ref)
    for key in ref:
        a, b = ours[key], ref[key]
        if isinstance(b, list) and b and isinstance(b[0], np.ndarray):
            assert len(a) == len(b), key
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y, err_msg=key)
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=key)


@pytest.mark.parametrize('seed', [0, 1])
@pytest.mark.parametrize('name,kwargs,make', STEPS,
                         ids=[f'{n}{i}' for i, (n, _, _) in
                              enumerate(STEPS)])
def test_pipeline_step_matches_jax(name, kwargs, make, seed):
    """The same input and seed give the same output, key by key."""
    results = make()
    outs = []
    for registry in (PIPELINES, JAX_PIPELINES):
        np.random.seed(seed)
        random.seed(seed)
        step = registry.get(name)(**copy.deepcopy(kwargs))
        outs.append(step(copy.deepcopy(results)))
    _assert_results_equal(*outs)


def test_raw_image_decode_and_image_dataset_match_jax(tmp_path):
    """``ImageDataset`` over a class-per-folder tree and over a list file,
    with ``RawImageDecode``: each image a 1-frame video."""
    rng = np.random.RandomState(1)
    lines = []
    for c, cls in enumerate(('cat', 'dog')):
        os.makedirs(tmp_path / 'imgs' / cls)
        for i in range(2):
            path = tmp_path / 'imgs' / cls / f'{i}.png'
            cv2.imwrite(str(path), rng.randint(0, 255, (20, 24, 3),
                                               np.uint8))
            lines.append(f'{path} {c}\n')
    (tmp_path / 'list.txt').write_text(''.join(lines))
    pipeline = [dict(type='RawImageDecode'),
                dict(type='CenterCrop', crop_size=16),
                dict(type='FormatShape', input_format='NCHW'),
                dict(type='Collect', keys=['imgs', 'label'], meta_keys=[])]
    for ann in (str(tmp_path / 'imgs'), str(tmp_path / 'list.txt')):
        cfg = dict(type='ImageDataset', ann_file=ann, pipeline=pipeline)
        ours, ref = build_dataset(cfg), jax_build_dataset(cfg)
        assert ours.video_infos == ref.video_infos
        assert [v['label'] for v in ours.video_infos] == [0, 0, 1, 1]
        for i in range(len(ref)):
            np.random.seed(i)
            a = ours[i]
            np.random.seed(i)
            b = ref[i]
            assert a['imgs'].shape == (1, 16, 16, 3)
            np.testing.assert_array_equal(a['imgs'], b['imgs'])
            assert a['label'] == b['label']


def test_video_dataset_evaluate_matches_jax(tmp_path):
    """``top{k}_acc`` and ``mean_class_accuracy`` over a dataset's
    labels; an unknown metric raises."""
    lines = [f'v{i}.mp4 {i % 4}\n' for i in range(12)]
    (tmp_path / 'list.txt').write_text(''.join(lines))
    cfg = dict(type='VideoDataset', ann_file=str(tmp_path / 'list.txt'),
               pipeline=[])
    ours, ref = build_dataset(cfg), jax_build_dataset(cfg)
    results = list(np.random.RandomState(2).randn(12, 6))
    metrics = ['top_k_accuracy', 'mean_class_accuracy']
    got = ours.evaluate(results, metrics, topk=(1, 2, 5))
    assert got == ref.evaluate(results, metrics, topk=(1, 2, 5))
    assert set(got) == {'top1_acc', 'top2_acc', 'top5_acc',
                        'mean_class_accuracy'}
    assert ours.evaluate(results) == ref.evaluate(results)
    with pytest.raises(KeyError):
        ours.evaluate(results, 'mAP')


TEST_PIPELINE = [
    dict(type='OpenCVInit'),
    dict(type='SampleFrames', clip_len=1, frame_interval=1, num_clips=3,
         test_mode=True),
    dict(type='OpenCVDecode'),
    dict(type='Resize', scale=(32, 32), keep_ratio=False),
    dict(type='Normalize', **NORM),
    dict(type='FormatShape', input_format='NCHW'),
    dict(type='Collect', keys=['imgs'], meta_keys=[]),
]
RECOGNIZER = dict(type='Recognizer2D',
                  backbone=dict(type='ResNetTSM', depth=18, num_segments=3),
                  cls_head=dict(type='TSMHead', num_classes=7,
                                in_channels=512, num_segments=3,
                                dropout_ratio=0.0))


@pytest.fixture(scope='module')
def recognition_setup(tmp_path_factory):
    """A video, a recognizer config, the JAX variables and the same
    weights as a port state dict."""
    root = tmp_path_factory.mktemp('recognition')
    ann = make_video_dataset(str(root / 'videos'), num_videos=1,
                             num_frames=9, hw=(40, 48))
    video = osp.join(osp.dirname(ann), 'vid0.mp4')
    config = root / 'tsm.py'
    config.write_text(
        f'model = {RECOGNIZER!r}\n'
        "test_cfg = dict(average_clips='prob')\n"
        f'data = dict(test=dict(pipeline={TEST_PIPELINE!r}))\n')
    labels = root / 'labels.txt'
    labels.write_text(''.join(f'class {c}\n' for c in 'abcde'))  # 5 of 7
    jmodel = jax_build_model(RECOGNIZER,
                             test_cfg=dict(average_clips='prob'))
    variables = jax_variables(jmodel, np.zeros((1, 3, 32, 32, 3),
                                               np.float32),
                              train=False, return_loss=False, seed=3)
    ckpt = root / 'tsm.pth'
    torch.save(flax_recognizer_to_torch(variables['params'],
                                        variables['batch_stats']), ckpt)
    return dict(video=video, config=str(config), labels=str(labels),
                jax=(jmodel, variables, JaxConfig.fromfile(str(config))),
                ckpt=str(ckpt), root=root)


def test_inference_recognizer_topk_matches_jax(recognition_setup):
    """The top-5 (label, score) pairs on the same weights; the label file
    lacks two classes, which both packages name ``class_{i}``."""
    s = recognition_setup
    model = init_recognizer(s['config'], s['ckpt'], device='cpu')
    assert not model.training
    for labels in (s['labels'], None):
        ours = inference_recognizer(model, s['video'], labels)
        ref = jax_inference_recognizer(s['jax'], s['video'], labels)
        assert [k for k, _ in ours] == [k for k, _ in ref]
        np.testing.assert_allclose([v for _, v in ours],
                                   [float(v) for _, v in ref], rtol=1e-5)
    ranked = inference_recognizer(model, s['video'], s['labels'], topk=7)
    assert {k for k, _ in ranked} >= {'class_5', 'class_6'}


def test_demo_recognition_on_the_cpu_and_no_gpu(recognition_setup,
                                                monkeypatch):
    s = recognition_setup
    out = str(s['root'] / 'labelled.mp4')
    buf = io.StringIO()
    with redirect_stdout(buf):
        results = demo_recognition.main([
            s['config'], s['ckpt'], s['video'], s['labels'],
            '--out-filename', out, '--device', 'cpu'])
    lines = buf.getvalue().splitlines()
    assert lines[0] == 'The top-5 labels with corresponding scores are:'
    assert lines[1:6] == [f'{k}: {float(v):.4f}' for k, v in results]
    cap = cv2.VideoCapture(out)
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 9
    cap.release()
    random_weights = demo_recognition.main([s['config'], 'random',
                                            s['video'], s['labels'],
                                            '--device', 'cpu'])
    assert len(random_weights) == 5
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        demo_recognition.main([s['config'], 'random', s['video'],
                               s['labels']])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_recognizer(s['config'])


def test_report_accuracy_prints_the_jax_tools_line(tmp_path):
    """Two score files (``.npy`` and ``.npz``) fused with coefficients:
    the same printed line as ``tools/analysis/report_accuracy.py``."""
    rng = np.random.RandomState(5)
    np.save(tmp_path / 'a.npy', rng.randn(20, 8))
    np.savez(tmp_path / 'b.npz', *list(rng.randn(20, 8)))
    (tmp_path / 'list.txt').write_text(
        ''.join(f'v{i} 16 {i % 8}\n' for i in range(20)))
    argv = ['--scores', str(tmp_path / 'a.npy'), str(tmp_path / 'b.npz'),
            '--coefficients', '1.0', '0.5', '--annotation',
            str(tmp_path / 'list.txt')]
    buf = io.StringIO()
    with redirect_stdout(buf):
        ours = report_accuracy.main(argv)
    ref_buf = io.StringIO()
    saved = sys.argv
    try:
        sys.argv = ['report_accuracy.py', *argv]
        with redirect_stdout(ref_buf):
            runpy.run_path(osp.join(ROOT, 'tools', 'analysis',
                                    'report_accuracy.py'),
                           run_name='__main__')
    finally:
        sys.argv = saved
    assert buf.getvalue() == ref_buf.getvalue()
    assert buf.getvalue().startswith('top1: ')
    assert set(ours) == {'top1', 'top5', 'mean_class_acc'}
