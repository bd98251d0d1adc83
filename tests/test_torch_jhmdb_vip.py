"""vfs_tpu_torch's JHMDB (pose propagation, PCK) and VIP (part
segmentation, mIoU) evals against the JAX package's on the CPU.

- The pose maps of ``RawFrameDecode`` (gaussian label maps drawn at the
  first frame's joints) equal the JAX package's exactly.
- ``img2coord``, PCK and ``mean_iou`` give equal numbers on the same
  inputs.
- ``python -m vfs_tpu_torch.tools.test --device cpu`` on the
  ``make_jhmdb`` and ``make_vip`` fixtures of
  ``tests/test_data/test_jhmdb_vip.py``, through a config written under
  ``tmp_path`` that holds the r18 config's ``model`` and ``test_cfg`` and
  the fixture's val pipeline at ``Resize(-1, 64)``, with
  ``test_cfg.video_engine=v1`` (``video_extract=perframe`` for JHMDB),
  against the chain ``tools/test.py`` runs in the JAX package with
  ``backend='tiled'`` (whose results equal its v1 engine's). JHMDB
  heatmaps agree within rtol 1e-4 / atol 1e-5 and PCK to 2 decimals; VIP
  masks are equal and mIoU equal to 4 decimals.

The fixture's near-static frames hold keys whose scores lie a few ulps
apart. The two packages' features and dot products round differently, so
where such a near tie sits at the k-th place, the last selected key can
differ and move a heatmap by up to ~5e-4 (the weight seeds 0 and 2 of the
fabricated r18 show one on this fixture; PCK and the VIP masks stay
equal). The fabricated weights here use seed 1, which has none.
"""

import importlib.util
import os.path as osp
import runpy

import numpy as np
import pytest
import torch

from vfs_tpu.apis import single_process_test as jax_single_process_test
from vfs_tpu.core.evaluation.accuracy import mean_iou as jax_mean_iou
from vfs_tpu.datasets import build_dataset as jax_build_dataset
from vfs_tpu.datasets.pipelines.loading import \
    RawFrameDecode as JaxRawFrameDecode
from vfs_tpu.models import build_model as jax_build_model
from vfs_tpu.utils import Config as JaxConfig
from vfs_tpu_torch.core.evaluation import mean_iou
from vfs_tpu_torch.datasets import build_dataset
from vfs_tpu_torch.datasets.pipelines import RawFrameDecode
from vfs_tpu_torch.datasets.pipelines.loading import draw_label_map
from vfs_tpu_torch.tools import test as tools_test

from test_torch_resnet import _torchvision_reference

torch.set_num_threads(1)

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
CONFIG = osp.join(ROOT, 'configs', 'r18_nc_sgd_cos_100e_r2_1xNx8_k400.py')
IMG_NORM = dict(mean=[123.675, 116.28, 103.53],
                std=[58.395, 57.12, 57.375], to_bgr=False)
PIPELINE = [
    dict(type='SequentialSampleFrames', frame_interval=1),
    dict(type='RawFrameDecode'),
    dict(type='Resize', scale=(-1, 64), keep_ratio=True),
    dict(type='Flip', flip_ratio=0),
    dict(type='Normalize', **IMG_NORM),
    dict(type='FormatShape', input_format='NCTHW'),
    dict(type='Collect', keys=['imgs', 'ref_seg_map'],
         meta_keys=('frame_dir', 'frame_inds', 'original_shape',
                    'seg_map')),
    dict(type='ToTensor', keys=['imgs', 'ref_seg_map']),
]


def _fixture_module():
    """tests/test_data/test_jhmdb_vip.py (make_jhmdb, make_vip), loaded by
    path: the test directories are not packages."""
    path = osp.join(ROOT, 'tests', 'test_data', 'test_jhmdb_vip.py')
    spec = importlib.util.spec_from_file_location('_jhmdb_vip_fixture',
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _dataset_cfg(kind, ann_file, img_root, ann_root, root):
    return dict(type=kind, ann_file=ann_file, data_prefix=img_root,
                anno_prefix=ann_root, data_root=root, pipeline=PIPELINE,
                test_mode=True)


@pytest.fixture(scope='module')
def slice3(tmp_path_factory):
    """Both fixtures (two videos each), one fabricated torchvision-layout
    r18 ``.pth`` and a config per dataset."""
    tmp = tmp_path_factory.mktemp('jhmdb_vip')
    fixture = _fixture_module()
    ref = _torchvision_reference()
    torch.manual_seed(1)  # no near tie at the k-th place (docstring)
    tmodel = ref.TorchResNet(ref.TorchBasicBlock, (2, 2, 2, 2),
                             strides=(1, 2, 1, 1))
    ref._randomize_bn_stats(tmodel)
    ckpt = str(tmp / 'r18.pth')
    torch.save(tmodel.state_dict(), ckpt)
    base = runpy.run_path(CONFIG)
    test_cfg = dict(base['test_cfg'], precede_frames=3)
    out = dict(ckpt=ckpt, tmp=tmp)
    for kind, make in (('JHMDBDataset', fixture.make_jhmdb),
                       ('VIPDataset', fixture.make_vip)):
        root = str(tmp / kind)
        ann_file, img_root, ann_root = make(root, num_videos=2)
        data = _dataset_cfg(kind, ann_file, img_root, ann_root, root)
        path = tmp / f'{kind}.py'
        path.write_text(f'model = {base["model"]!r}\n'
                        f'test_cfg = {test_cfg!r}\n'
                        f'data = {dict(test=data)!r}\n')
        out[kind] = (str(path), data)
    return out


def _jax_eval(config, ckpt, metric):
    cfg = JaxConfig.fromfile(config)
    cfg.merge_from_dict({'test_cfg.backend': 'tiled'})
    dataset = jax_build_dataset(cfg.data.test, dict(test_mode=True))
    model_cfg = dict(type='VanillaTracker', backbone=dict(cfg.model.backbone))
    model_cfg['backbone']['pretrained'] = ckpt
    model = jax_build_model(model_cfg, test_cfg=cfg.test_cfg)
    model.init_weights()
    results = jax_single_process_test(model, dataset, progress=False,
                                      prefetch=False)
    return results, dataset.evaluate(results, metrics=[metric])


def _port_eval(config, ckpt, metric, out_npz, options):
    got = tools_test.main([config, ckpt, '--eval', metric, '--device', 'cpu',
                           '--out', out_npz, '--options', *options])
    with np.load(out_npz) as saved:
        results = [saved[k] for k in sorted(saved.files,
                                            key=lambda n: int(n[4:]))]
    return results, got


def test_pose_maps_match_jax(slice3):
    """The first frame's gaussian joint maps, sigma 4 and sigma 0, with
    joints inside, on the border of and outside the frame."""
    info = build_dataset(slice3['JHMDBDataset'][1]).video_infos[0]
    coord = np.array([[5.0, 0.0, 79.0, 40.5, -3.0, 90.0, 12.0],
                      [7.0, 63.0, 2.0, 30.2, 10.0, 20.0, -20.0]])
    for sigma in (4, 0):
        results = dict(frame_dir=info['frame_dir'], filename_tmpl='{:05}.png',
                       frame_inds=np.arange(1, 4), pose_coord=coord,
                       sigma=sigma)
        got = RawFrameDecode()(dict(results))['ref_seg_map']
        ref = JaxRawFrameDecode()(dict(results))['ref_seg_map']
        assert got.dtype == ref.dtype == np.float32
        assert got.shape == (64, 80, 7)
        np.testing.assert_array_equal(got, ref)
    img = np.zeros((9, 11), np.float32)
    draw_label_map(img, (10.0, 0.0), 1)
    assert img.max() == 1.0 and img[0, 10] == 1.0


def test_jhmdb_samples_match_jax(slice3):
    cfg = slice3['JHMDBDataset'][1]
    got, ref = build_dataset(cfg)[1], jax_build_dataset(cfg)[1]
    np.testing.assert_array_equal(got['ref_seg_map'], ref['ref_seg_map'])
    np.testing.assert_array_equal(got['imgs'], ref['imgs'])
    assert got['ref_seg_map'].shape == (64, 80, 15)


def test_img2coord_pck_and_mean_iou_match_jax(slice3):
    rng = np.random.RandomState(0)
    cfg = slice3['JHMDBDataset'][1]
    port, jax = build_dataset(cfg), jax_build_dataset(cfg)
    heat = [rng.rand(6, 15, 64, 80).astype(np.float32) for _ in range(2)]
    heat[1][2, 4] = 0  # an all-zero heatmap decodes to -1
    with np.errstate(invalid='ignore'):  # its soft-argmax divides 0 by 0
        np.testing.assert_array_equal(port.img2coord(heat[1]),
                                      jax.img2coord(heat[1]))
        assert (port.img2coord(heat[1])[:, 4, 2] == -1).all()
        assert port.evaluate(heat) == jax.evaluate(heat)
    preds = [rng.randint(0, 20, (7, 9)) for _ in range(3)]
    labels = [rng.randint(0, 20, (7, 9)) for _ in range(3)]
    labels[0][:2] = 255  # ignored
    for a, b in zip(mean_iou(preds, labels, 20),
                    jax_mean_iou(preds, labels, 20)):
        np.testing.assert_array_equal(a, b)


def test_tools_test_jhmdb_matches_jax_chain(slice3):
    config, _ = slice3['JHMDBDataset']
    results, got = _port_eval(
        config, slice3['ckpt'], 'pck', str(slice3['tmp'] / 'jhmdb.npz'),
        ['test_cfg.video_engine=v1', 'test_cfg.video_extract=perframe'])
    ref_results, ref = _jax_eval(config, slice3['ckpt'], 'pck')
    assert len(results) == len(ref_results) == 2
    for a, b in zip(results, ref_results):
        assert a.shape == (6, 15, 64, 80) and a.dtype == np.float32
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-5)
    assert set(got) == set(ref) == {f'PCK@{t}'
                                    for t in (0.1, 0.2, 0.3, 0.4, 0.5)}
    for key in ref:
        assert round(got[key], 2) == round(ref[key], 2), key


def test_tools_test_vip_matches_jax_chain(slice3):
    config, _ = slice3['VIPDataset']
    results, got = _port_eval(
        config, slice3['ckpt'], 'mIoU', str(slice3['tmp'] / 'vip.npz'),
        ['test_cfg.video_engine=v1'])
    ref_results, ref = _jax_eval(config, slice3['ckpt'], 'mIoU')
    assert len(results) == len(ref_results) == 2
    for a, b in zip(results, ref_results):
        assert a.shape == (5, 48, 64) and a.dtype == np.uint8
        np.testing.assert_array_equal(a, np.asarray(b))
    assert set(got) == set(ref) == {'mIoU', 'mAcc', 'aAcc'}
    for key in ref:
        assert round(got[key], 4) == round(ref[key], 4), key
