"""vfs_tpu_torch VanillaTracker.forward_test against the JAX package's on
the CPU: an in-memory moving-squares video (64x96, 10 frames, 2 objects,
uint8 + img_norm_cfg), the r18 eval test_cfg of
configs/r18_nc_sgd_cos_100e_r2_1xNx8_k400.py with precede_frames lowered
so the ring wraps (T > P), and shared weights (flax init with randomised
BN, carried over by ``flax_resnet_to_torch``). Masks must be
pixel-identical, and the port's copy of the J&F code must give the JAX
package's numbers on them."""

import os.path as osp
import runpy

import numpy as np
import pytest
import torch

from vfs_tpu.core.evaluation import davis as jax_davis
from vfs_tpu.models import build_model as jax_build_model
from vfs_tpu_torch.checkpoint import flax_resnet_to_torch
from vfs_tpu_torch.core.evaluation import davis as torch_davis
from vfs_tpu_torch.models import build_model

from test_torch_resnet import jax_resnet_variables

torch.set_num_threads(1)

CONFIG = osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))),
                  'configs', 'r18_nc_sgd_cos_100e_r2_1xNx8_k400.py')
CONFIG_R50 = osp.join(osp.dirname(CONFIG),
                      'r50_nc_sgd_cos_100e_r5_1xNx2_k400.py')


def make_video(num_frames=10, hw=(64, 96), seed=0):
    """Moving coloured squares over a random background, as
    tests/test_data/test_davis_e2e.py's make_mini_davis, in memory."""
    h, w = hw
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 60, (h, w, 3), np.uint8)
    imgs = np.empty((num_frames, h, w, 3), np.uint8)
    labels = np.zeros((num_frames, h, w), np.uint8)
    for t in range(num_frames):
        img = base.copy()
        y1, x1 = 8 + t, 10 + t
        img[y1:y1 + 16, x1:x1 + 16] = [220, 40, 40]
        labels[t, y1:y1 + 16, x1:x1 + 16] = 1
        y2, x2 = 34, 50 + t
        img[y2:y2 + 14, x2:x2 + 14] = [40, 220, 60]
        labels[t, y2:y2 + 14, x2:x2 + 14] = 2
        imgs[t] = img
    return imgs, labels


@pytest.fixture(scope='module')
def trackers():
    cfg = runpy.run_path(CONFIG)
    test_cfg = dict(cfg['test_cfg'], precede_frames=4)
    model_cfg = dict(type='VanillaTracker',
                     backbone=dict(cfg['model']['backbone']))
    _, variables = jax_resnet_variables(18, (1, 2, 1, 1), (2,), seed=3,
                                        hw=(64, 96))
    jax_tracker = jax_build_model(model_cfg, test_cfg=test_cfg)
    jax_tracker.variables = variables
    port = build_model(model_cfg, test_cfg=test_cfg)
    port.load_weights(flax_resnet_to_torch(variables['params'],
                                           variables['batch_stats']))
    meta = [dict(original_shape=(64, 96),
                 img_norm_cfg=dict(cfg['img_norm_cfg']))]
    return jax_tracker, port, meta


def _jf(davis, gt, pred):
    res = davis.aggregate_metrics(
        {'v': davis.evaluate_semisupervised(gt.astype(np.int64),
                                            pred.astype(np.int64))})
    return {k: (np.mean(res[k]['M']), np.mean(res[k]['R']),
                np.mean(res[k]['D'])) for k in ('J', 'F')}


def test_forward_test_masks_match_jax(trackers):
    jax_tracker, port, meta = trackers
    imgs, labels = make_video()
    ref = jax_tracker.forward_test(imgs, labels[0], meta)
    thunk = port.forward_test(imgs, labels[0], meta, defer_fetch=True,
                              device='cpu')
    out = thunk()
    assert len(out) == len(ref) == 1
    assert out[0].shape == (10, 64, 96) and out[0].dtype == np.uint8
    np.testing.assert_array_equal(out[0], ref[0])
    np.testing.assert_array_equal(out[0][0], labels[0])
    jf_port = _jf(torch_davis, labels, out[0])
    jf_ref = _jf(jax_davis, labels, ref[0])
    assert jf_port == jf_ref
    assert 0.0 <= jf_port['J'][0] <= 1.0


def test_forward_test_soft_labels_match_jax(trackers):
    """(H, W, K) heatmaps: bilinear both ways, the >2x downsample included;
    returns (T, K, H0, W0) per-frame heatmaps."""
    jax_tracker, port, meta = trackers
    imgs, labels = make_video(num_frames=6, seed=1)
    heat = np.eye(3, dtype=np.float32)[labels[0]]
    ref = jax_tracker.forward_test(imgs, heat, meta)
    out = port.forward_test(imgs, heat, meta, device='cpu')
    assert out[0].shape == ref[0].shape == (6, 3, 64, 96)
    np.testing.assert_allclose(out[0], ref[0], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize('extra,config', [
    pytest.param(dict(all_blocks=True), CONFIG, id='extra0'),
    pytest.param(dict(save_np=True), CONFIG, id='extra1'),
    pytest.param(dict(all_blocks=True), CONFIG_R50, id='all_blocks_r50')])
def test_forward_test_branches_match_jax(extra, config, tmp_path,
                                         monkeypatch):
    """all_blocks (one prediction per layer3 block, stacked: 2 at r18, 6
    Bottlenecks at r50) and save_np (predictions written to .eval/*.npy,
    paths returned)."""
    monkeypatch.chdir(tmp_path)
    cfg = runpy.run_path(config)
    test_cfg = dict(cfg['test_cfg'], precede_frames=3, **extra)
    model_cfg = dict(type='VanillaTracker',
                     backbone=dict(cfg['model']['backbone']))
    depth = cfg['model']['backbone']['depth']
    _, variables = jax_resnet_variables(depth, (1, 2, 1, 1), (2,), seed=4,
                                        hw=(64, 96))
    jax_tracker = jax_build_model(model_cfg, test_cfg=test_cfg)
    jax_tracker.variables = variables
    port = build_model(model_cfg, test_cfg=test_cfg)
    port.load_weights(flax_resnet_to_torch(variables['params'],
                                           variables['batch_stats']))
    meta = [dict(original_shape=(64, 96),
                 img_norm_cfg=dict(cfg['img_norm_cfg']))]
    imgs, labels = make_video(num_frames=6, seed=2)
    ref = jax_tracker.forward_test(imgs, labels[0], meta)
    out = port.forward_test(imgs, labels[0], meta, device='cpu')
    if extra.get('save_np'):
        assert out[0] != ref[0] and out[0].startswith('.eval')
        ref, out = [np.load(ref[0])], [np.load(out[0])]
    assert len(out) == len(ref)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    if extra.get('all_blocks'):
        # layer3 has 2 blocks at r18, 6 at r50
        blocks = 2 if depth == 18 else 6
        assert out[0].shape == (blocks, 6, 64, 96)


def test_later_slice_options_raise(trackers):
    """The two options refused before slice 8 ported them: ``distribute``
    gives one backbone per device, the model's own on its device and a copy
    elsewhere (here the meta device), keeping nothing on the model, and
    ``forward_test`` runs the one it is handed (the same masks); and
    ``input_format='yuv420'`` gives the JAX package's yuv420 masks pixel
    for pixel."""
    jax_tracker, port, meta = trackers
    imgs, labels = make_video(num_frames=3)
    ref = port.forward_test(imgs, labels[0], meta, device='cpu')
    backbones = port.distribute(['cpu', 'cpu'])
    assert backbones == [port.backbone] * 2 and not port.backbone.training
    moved = port.distribute(['meta'])[0]
    assert moved is not port.backbone
    assert next(moved.parameters()).device == torch.device('meta')
    out = port.forward_test(imgs, labels[0], meta, device='cpu',
                            backbone=backbones[0])
    np.testing.assert_array_equal(out[0], ref[0])
    port.test_cfg['input_format'] = 'yuv420'
    jax_tracker.test_cfg['input_format'] = 'yuv420'
    try:
        out = port.forward_test(imgs, labels[0], meta, device='cpu')
        ref = jax_tracker.forward_test(imgs, labels[0], meta)
        np.testing.assert_array_equal(out[0], ref[0])
    finally:
        port.test_cfg.pop('input_format')
        jax_tracker.test_cfg.pop('input_format')
