"""vfs_tpu_torch's config system, DAVIS dataset and eval pipeline against
the JAX package's on the CPU: the same config dicts from every shipped
config, equal samples (frames, first-frame labels, meta) from the
mini-DAVIS fixture of ``tests/test_data/test_davis_e2e.py``, and equal J&F
from ``evaluate``."""

import glob
import importlib.util
import os.path as osp

import numpy as np
import pytest
import torch

from vfs_tpu.datasets import build_dataset as jax_build_dataset
from vfs_tpu.utils import Config as JaxConfig
from vfs_tpu.utils import parse_options as jax_parse_options
from vfs_tpu_torch.datasets import build_dataset
from vfs_tpu_torch.utils import Config, parse_options

torch.set_num_threads(1)

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
CONFIGS = sorted(glob.glob(osp.join(ROOT, 'configs', '*.py')))


def davis_fixture_module():
    """tests/test_data/test_davis_e2e.py (make_mini_davis, VAL_PIPELINE),
    loaded by path: the test directories are not packages."""
    path = osp.join(ROOT, 'tests', 'test_data', 'test_davis_e2e.py')
    spec = importlib.util.spec_from_file_location('_davis_fixture', path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope='module')
def mini_davis(tmp_path_factory):
    fixture = davis_fixture_module()
    root = str(tmp_path_factory.mktemp('davis'))
    ann_file, img_root, ann_root = fixture.make_mini_davis(root)
    return ann_file, img_root, ann_root, fixture.VAL_PIPELINE


def _davis_cfg(mini_davis, pipeline):
    ann_file, img_root, ann_root, _ = mini_davis
    return dict(type='DavisDataset', ann_file=ann_file,
                data_prefix=img_root, anno_prefix=ann_root,
                data_root=osp.dirname(img_root), pipeline=pipeline,
                test_mode=True)


def test_five_configs_shipped():
    assert len(CONFIGS) == 5


@pytest.mark.parametrize('path', CONFIGS, ids=osp.basename)
def test_config_fromfile_matches_jax(path):
    cfg, ref = Config.fromfile(path), JaxConfig.fromfile(path)
    assert cfg.to_dict() == ref.to_dict()
    assert cfg.text == ref.text and cfg.filename == ref.filename
    options = ['test_cfg.backend=pallas', 'test_cfg.topk=5',
               'data.test.ann_file=/x/list.txt', 'test_cfg.save_np=True',
               'test_cfg.strides=(1,2,1,1)', 'new.key=none']
    assert parse_options(options) == jax_parse_options(options)
    cfg.merge_from_dict(parse_options(options))
    ref.merge_from_dict(jax_parse_options(options))
    assert cfg.to_dict() == ref.to_dict()
    assert cfg.test_cfg.backend == 'pallas' and cfg.new.key is None


@pytest.mark.parametrize('on_device', [False, True])
def test_davis_samples_match_jax(mini_davis, on_device):
    pipeline = [dict(t) for t in mini_davis[3]]
    for t in pipeline:
        if t['type'] == 'Normalize':
            t['on_device'] = on_device
    ds = build_dataset(_davis_cfg(mini_davis, pipeline))
    ref = jax_build_dataset(_davis_cfg(mini_davis, pipeline))
    assert len(ds) == len(ref) == 2
    for i in range(len(ds)):
        a, b = ds[i], ref[i]
        assert set(a) == set(b) == {'imgs', 'ref_seg_map', 'img_meta'}
        assert a['imgs'].dtype == b['imgs'].dtype
        assert a['imgs'].shape == (1, 8, 64, 96, 3)
        np.testing.assert_array_equal(a['imgs'], b['imgs'])
        np.testing.assert_array_equal(a['ref_seg_map'], b['ref_seg_map'])
        assert set(a['img_meta']) == set(b['img_meta'])
        for key, value in a['img_meta'].items():
            if key == 'img_norm_cfg':
                for k in ('mean', 'std'):
                    np.testing.assert_array_equal(value[k], b['img_meta'][
                        key][k])
                assert value['to_bgr'] == b['img_meta'][key]['to_bgr']
            else:
                np.testing.assert_array_equal(value, b['img_meta'][key])


def test_davis_resize_relabels_like_jax(mini_davis):
    """A short-side upscale (Resize(-1, 96)) takes the PIL-nearest path
    for the uint8 label map, the J&F parity trap of the reference."""
    pipeline = [dict(t) for t in mini_davis[3]]
    pipeline[2] = dict(type='Resize', scale=(-1, 96), keep_ratio=True)
    a = build_dataset(_davis_cfg(mini_davis, pipeline))[1]
    b = jax_build_dataset(_davis_cfg(mini_davis, pipeline))[1]
    assert a['ref_seg_map'].shape == (96, 144)
    np.testing.assert_array_equal(a['ref_seg_map'], b['ref_seg_map'])
    np.testing.assert_array_equal(a['imgs'], b['imgs'])


def test_davis_evaluate_matches_jax(mini_davis, tmp_path):
    ds = build_dataset(_davis_cfg(mini_davis, mini_davis[3]))
    ref = jax_build_dataset(_davis_cfg(mini_davis, mini_davis[3]))
    gt = [ds._load_gt_masks(i) for i in range(len(ds))]
    for a, b in zip(gt, [ref._load_gt_masks(i) for i in range(len(ref))]):
        np.testing.assert_array_equal(a, b)
    perfect = ds.evaluate(gt, metrics='davis')
    assert perfect == ref.evaluate(gt, metrics='davis')
    assert perfect['J&F-Mean'] == pytest.approx(1.0)
    # predictions: the objects shifted by a few pixels, one frame blanked
    rng = np.random.RandomState(0)
    preds = []
    for g in gt:
        p = np.roll(g, shift=(rng.randint(1, 4), rng.randint(1, 4)),
                    axis=(1, 2))
        p[3] = 0
        preds.append(p.astype(np.uint8))
    out_dir = tmp_path / 'pngs'
    got = ds.evaluate(preds, metrics=['davis'], output_dir=str(out_dir))
    assert got == ref.evaluate(preds, metrics=['davis'])
    assert 0.0 < got['J&F-Mean'] < 1.0
    assert len(list(out_dir.rglob('*.png'))) == 16
    # multi-feature results get feat_{i}. prefixes
    multi = ds.evaluate([np.stack([p, g]) for p, g in zip(preds, gt)])
    assert multi == ref.evaluate([np.stack([p, g])
                                  for p, g in zip(preds, gt)])
    assert multi['feat_1.J&F-Mean'] == pytest.approx(1.0)
