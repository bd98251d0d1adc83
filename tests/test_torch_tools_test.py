"""``python -m vfs_tpu_torch.tools.test`` (``--device cpu``) against the
JAX package's eval chain on the mini-DAVIS fixture.

A config written under ``tmp_path`` holds the r18 config's ``model`` and
``test_cfg`` with ``backend='pallas'`` (the scan tier) and
``precede_frames=3`` (so the ring wraps on the 8-frame fixture videos),
the fixture's paths, and the fixture's val pipeline at ``Resize(-1, 64)``
(the configs' own ``Resize(-1, 480)`` would upscale the 64x96 fixture far
past a CPU test's size). Both sides load one fabricated torchvision-layout
r18 ``.pth``. The JAX side runs the chain ``tools/test.py`` runs
(``Config.fromfile``, ``build_dataset``, ``build_model``,
``single_process_test``, ``evaluate``) with ``backend='tiled'``, whose
results equal its ``'pallas'`` scan. Masks must be equal and J&F equal to
4 decimals.
"""

import os.path as osp
import runpy

import numpy as np
import pytest
import torch

from vfs_tpu.apis import single_process_test as jax_single_process_test
from vfs_tpu.datasets import build_dataset as jax_build_dataset
from vfs_tpu.models import build_model as jax_build_model
from vfs_tpu.utils import Config as JaxConfig
from vfs_tpu_torch.tools import test as tools_test

from test_torch_datasets import davis_fixture_module
from test_torch_resnet import _torchvision_reference

torch.set_num_threads(1)

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
CONFIG = osp.join(ROOT, 'configs', 'r18_nc_sgd_cos_100e_r2_1xNx8_k400.py')
CONFIG_R50 = osp.join(ROOT, 'configs', 'r50_nc_sgd_cos_100e_r5_1xNx2_k400.py')


def _write_setup(tmp, config, name, block, layers):
    """The mini-DAVIS fixture, a fabricated torchvision-layout ``.pth`` of
    ``block`` x ``layers`` and a config of ``config``'s model and
    ``test_cfg`` at the fixture's size, under ``tmp``."""
    fixture = davis_fixture_module()
    ann_file, img_root, ann_root = fixture.make_mini_davis(str(tmp))
    ref = _torchvision_reference()
    torch.manual_seed(0)
    tmodel = ref.TorchResNet(getattr(ref, block), layers,
                             strides=(1, 2, 1, 1))
    ref._randomize_bn_stats(tmodel)
    ckpt = str(tmp / f'{name}.pth')
    torch.save(tmodel.state_dict(), ckpt)

    base = runpy.run_path(config)
    test_cfg = dict(base['test_cfg'], backend='pallas', precede_frames=3,
                    batch_step=4)
    davis = dict(type='DavisDataset', ann_file=ann_file,
                 data_prefix=img_root, anno_prefix=ann_root,
                 data_root=osp.dirname(img_root),
                 pipeline=fixture.VAL_PIPELINE, test_mode=True)
    path = tmp / f'{name}_fixture.py'
    path.write_text(f'model = {base["model"]!r}\n'
                    f'test_cfg = {test_cfg!r}\n'
                    f'data = {dict(test=davis)!r}\n')
    return str(path), ckpt, tmp


@pytest.fixture(scope='module')
def eval_setup(tmp_path_factory):
    return _write_setup(tmp_path_factory.mktemp('tools_test'), CONFIG,
                        'r18', 'TorchBasicBlock', (2, 2, 2, 2))


@pytest.fixture(scope='module')
def eval_setup_r50(tmp_path_factory):
    return _write_setup(tmp_path_factory.mktemp('tools_test_r50'),
                        CONFIG_R50, 'r50', 'TorchBottleneck', (3, 4, 6, 3))


def _jax_eval(config, ckpt, **options):
    cfg = JaxConfig.fromfile(config)
    cfg.merge_from_dict({'test_cfg.backend': 'tiled', **options})
    dataset = jax_build_dataset(cfg.data.test, dict(test_mode=True))
    model_cfg = dict(type='VanillaTracker', backbone=dict(cfg.model.backbone))
    model_cfg['backbone']['pretrained'] = ckpt
    model = jax_build_model(model_cfg, test_cfg=cfg.test_cfg)
    model.init_weights()
    results = jax_single_process_test(model, dataset, progress=False,
                                      prefetch=False)
    return results, dataset.evaluate(results, metrics=['davis'])


def test_tools_test_matches_jax_chain(eval_setup, capsys):
    config, ckpt, tmp = eval_setup
    out_npz = str(tmp / 'results.npz')
    got = tools_test.main([config, ckpt, '--eval', 'davis', '--device',
                           'cpu', '--out', out_npz, '--output-dir',
                           str(tmp / 'pngs'), '--options',
                           'test_cfg.topk=10'])
    printed = capsys.readouterr().out
    assert f'J&F-Mean: {got["J&F-Mean"]:.04f}' in printed
    ref_results, ref = _jax_eval(config, ckpt)
    with np.load(out_npz) as saved:
        masks = [saved[k] for k in sorted(saved.files,
                                          key=lambda n: int(n[4:]))]
    assert len(masks) == len(ref_results) == 2
    for a, b in zip(masks, ref_results):
        assert a.shape == (8, 64, 96) and a.dtype == np.uint8
        np.testing.assert_array_equal(a, np.asarray(b))
    assert set(got) == set(ref)
    for key in ref:
        assert round(got[key], 4) == round(ref[key], 4), key
    assert 0.0 <= got['J&F-Mean'] <= 1.0
    assert len(list((tmp / 'pngs').rglob('*.png'))) == 16


def test_tools_test_all_blocks_r50_matches_jax_chain(eval_setup_r50):
    """``--options test_cfg.all_blocks=True`` on the r50 config: a
    prediction for each of layer3's six Bottlenecks, evaluated under the
    ``feat_{i}.`` prefixes, equal to the JAX package's masks and
    metrics."""
    config, ckpt, tmp = eval_setup_r50
    out_npz = str(tmp / 'all_blocks.npz')
    got = tools_test.main([config, ckpt, '--eval', 'davis', '--device',
                           'cpu', '--out', out_npz, '--options',
                           'test_cfg.all_blocks=True'])
    ref_results, ref = _jax_eval(config, ckpt,
                                 **{'test_cfg.all_blocks': True})
    with np.load(out_npz) as saved:
        masks = [saved[k] for k in sorted(saved.files,
                                          key=lambda n: int(n[4:]))]
    assert len(masks) == len(ref_results) == 2
    for a, b in zip(masks, ref_results):
        assert a.shape == (6, 8, 64, 96) and a.dtype == np.uint8
        np.testing.assert_array_equal(a, np.asarray(b))
    assert {f'feat_{i}.J&F-Mean' for i in range(6)} <= set(got)
    assert set(got) == set(ref)
    for key in ref:
        assert round(got[key], 4) == round(ref[key], 4), key


def test_tools_test_runs_on_cuda_by_default(eval_setup, monkeypatch):
    """No device argument and no GPU: the CLI raises instead of falling
    back to the CPU."""
    config, ckpt, _ = eval_setup
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tools_test.main([config, ckpt])
