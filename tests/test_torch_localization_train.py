"""Training the port's localizers against the JAX package: two Adam steps
of BMN (its PEM regression fed the JAX step's uniform draws) and of SSN
(a ResNet-18 at 32x32, dropout 0, BatchNorm in training mode) through
each package's ``make_localizer_train_step``, from the same weights
(``flax_localizer_to_torch``) on the same batches: the losses and every
parameter update as one vector (tolerances at the test).
Also: ``train_localizer_model`` end to end for the four localizers (the
JAX tests' fixtures; losses finite, checkpoints written, ``--validate``
logging a val loss as ``tests/test_core/test_localization_train.py``
checks the JAX loop), resuming from a checkpoint, the train CLI on
localizer configs, ``tools.data.tsn_feature_extraction`` against the JAX
recognizer's scores, and the entry points' refusal to run without a GPU
unless asked for the CPU.
"""

import json
import os
import os.path as osp
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfs_tpu.apis.train import TrainState as JaxTrainState
from vfs_tpu.apis.train_localizer import _KINDS as JAX_KINDS
from vfs_tpu.apis.train_localizer import \
    make_localizer_train_step as jax_make_step
from vfs_tpu.core.optimizer import build_optimizer as jax_build_optimizer
from vfs_tpu.datasets import build_dataloader as jax_build_dataloader
from vfs_tpu.datasets import build_dataset as jax_build_dataset
from vfs_tpu.models import build_model as jax_build_model
from vfs_tpu.models.heads import ssn_head as jax_ssn_head
from vfs_tpu_torch.apis import (make_localizer_train_step, prepare_batch,
                                train_localizer_model)
from vfs_tpu_torch.checkpoint import flax_localizer_to_torch
from vfs_tpu_torch.core.optimizer import build_optimizer
from vfs_tpu_torch.datasets import build_dataset
from vfs_tpu_torch.models import build_model
from vfs_tpu_torch.tools import train as tools_train
from vfs_tpu_torch.utils import Config

from test_core.test_localization_train import (FEAT_DIM, T_SCALE,
                                               make_activitynet,
                                               make_pgm_fixture,
                                               make_ssn_rawframes)
from test_data.test_ssn import TEST_CFG, TRAIN_CFG, make_proposal_file
from test_torch_localization_models import (BMN_CFG, F64_TOL, PEM_CFG,
                                            SSN_CFG, TEM_CFG, carried)
from test_torch_recognition import jax_variables

torch.set_num_threads(1)

ADAM = dict(type='Adam', lr=0.01)
# SSN's parity steps: a larger epsilon, so that a gradient entry at the
# level of the JAX step's fp32 parts (its OHEM backward and loss terms
# are fp32 under x64; the completeness bias's gradient is an exact 0
# there and 1e-13 in the port) stays a small update instead of a whole
# lr * g / |g| step (with optax's default 1e-8 the updates differ by
# 1.3e-3, with 1e-4 by 4.1e-4, with 1e-3 by 2.2e-6)
SSN_ADAM = dict(ADAM, eps=1e-3)
# the update of two Adam steps, fp32 against optax's fp32, relative L2
STEP_TOL = 1e-4
FEATURE_PIPELINE = [dict(type='LoadLocalizationFeature'),
                    dict(type='GenerateLocalizationLabels'),
                    dict(type='Collect', keys=['raw_feature', 'gt_bbox'],
                         meta_keys=('video_name',))]


def _anet_cfg(root, pipeline=FEATURE_PIPELINE):
    return dict(type='ActivityNetDataset', ann_file=make_activitynet(root),
                data_prefix=root, pipeline=pipeline)


def _pem_cfg(root):
    pdir, fdir = make_pgm_fixture(root)
    return dict(type='ActivityNetDataset', ann_file=make_activitynet(root),
                data_prefix=root, pipeline=[
                    dict(type='LoadProposals', top_k=16,
                         pgm_proposals_dir=pdir, pgm_features_dir=fdir),
                    dict(type='Collect',
                         keys=['bsp_feature', 'reference_temporal_iou'],
                         meta_keys=('video_name',))])


SSN_PIPELINE = [
    dict(type='SampleProposalFrames', clip_len=1, body_segments=5,
         aug_segments=(2, 2), aug_ratio=0.5),
    dict(type='RawFrameDecode'),
    dict(type='Resize', scale=(32, 32), keep_ratio=False),
    dict(type='Normalize', mean=[128.0] * 3, std=[64.0] * 3),
    dict(type='FormatShape', input_format='NHWC'),
    dict(type='Collect', keys=['imgs', 'proposal_scale_factor',
                               'proposal_type', 'proposal_labels',
                               'reg_targets'], meta_keys=())]


def _ssn_cfg(root):
    ann = osp.join(root, 'proposals.txt')
    make_proposal_file(ann)
    make_ssn_rawframes(root)
    return dict(type='SSNDataset', ann_file=ann, pipeline=SSN_PIPELINE,
                train_cfg=TRAIN_CFG, test_cfg=TEST_CFG, data_prefix=root,
                body_segments=5, aug_segments=(2, 2), aug_ratio=0.5,
                filename_tmpl='img_{:05d}.jpg')


def _batches(data_cfg, batch_size, n=2):
    """The JAX loader's first ``n`` batches (the global numpy stream
    seeded, for SSN's sampling)."""
    np.random.seed(0)
    loader = jax_build_dataloader(jax_build_dataset(data_cfg),
                                  videos_per_gpu=batch_size,
                                  workers_per_gpu=0, shuffle=False)
    batches = []
    for batch in loader:
        batches.append(batch)
        if len(batches) == n:
            return batches
    return batches


def _ssn_variables(model, tensors, dtype=np.float32):
    """The backbone's variables from the features-only path and the
    head's from its own init (the OHEM loss runs eagerly only)."""
    imgs = jnp.asarray(tensors['imgs'])
    variables = jax_variables(model, imgs, train=True, return_loss=False,
                              dtype=dtype)
    head = jax_ssn_head.SSNHead(**{k: v for k, v in
                                   SSN_CFG['cls_head'].items()
                                   if k != 'type'})
    feats = model.apply(variables, imgs, train=False, return_loss=False)
    head_vars = jax_variables(head, feats, jnp.asarray(
        tensors['proposal_scale_factor']), train=False, seed=1, dtype=dtype)
    variables['params'] = dict(variables['params'],
                               _cls_head=head_vars['params'])
    return variables


def _flat(sd, names):
    return torch.cat([sd[n].double().flatten() for n in names])


def _jax_steps(kind, jax_model, jax_tensors, variables, opt_cfg):
    """Two steps of the JAX loop: the losses, the start and final state
    dicts (as the port names them) and each step's two uniform draws of
    the BMN loss."""
    tx, _ = jax_build_optimizer(opt_cfg, None, 10)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32),
                          params=variables['params'],
                          batch_stats=variables['batch_stats'],
                          opt_state=tx.init(variables['params']))
    step = jax.jit(jax_make_step(jax_model, tx, kind))
    rng = jax.random.PRNGKey(0)
    losses, draws = [], []
    for tensors in jax_tensors:
        rng, step_rng = jax.random.split(rng)
        shape = tensors.get('label_confidence', np.zeros(1)).shape
        draws.append([np.asarray(jax.random.uniform(k, shape))
                      for k in jax.random.split(step_rng)])
        state, log_vars = step(state, {k: jnp.asarray(v) for k, v in
                                       tensors.items()}, step_rng)
        losses.append(float(log_vars['loss']))
    final = flax_localizer_to_torch(jax.tree.map(np.asarray, state.params),
                                    jax.tree.map(np.asarray,
                                                 state.batch_stats))
    start = flax_localizer_to_torch(variables['params'],
                                    variables['batch_stats'])
    return losses, start, final, draws


@pytest.mark.parametrize('kind', ['BMN', 'SSN'])
def test_two_adam_steps_match_optax(kind, tmp_path):
    """Two steps of the port's loop and of the JAX loop from the same
    weights on the same batches: the losses, and the update of every
    parameter (and BatchNorm statistic) as one vector. BMN in fp32, within
    fp32 rounding (``STEP_TOL``). SSN with the port in fp64 against the
    JAX package under x64 (its ResNet with ``dtype=float64``; its OHEM
    backward stays fp32), within 1e-4, with ``SSN_ADAM``: in fp32 on both
    sides the backbone's gradients differ by 1e-3 between the packages
    (flax's BatchNorm statistics over 2x2 and 1x1 maps amplify rounding),
    and Adam's first step, lr * g / |g|, turns the signs of the near-zero
    entries into whole steps."""
    root = str(tmp_path)
    if kind == 'BMN':
        cfg, batches = BMN_CFG, _batches(_anet_cfg(root), 2)
        jax_model = jax_build_model(cfg)
        prepare, _ = JAX_KINDS[kind]
        jax_tensors = [prepare(jax_model, b) for b in batches]
        variables = jax_variables(jax_model, jax_tensors[0]['raw_feature'],
                                  train=True)
        opt_cfg, dtype, tol = ADAM, torch.float32, STEP_TOL
        losses, start, final, draws = _jax_steps(kind, jax_model,
                                                 jax_tensors, variables,
                                                 opt_cfg)
    else:
        cfg, batches = SSN_CFG, _batches(_ssn_cfg(root), 1)
        for b in batches:
            b['imgs'] = np.asarray(b['imgs'], np.float64)
            b['reg_targets'] = np.asarray(b['reg_targets'], np.float64)
            b['proposal_scale_factor'] = np.asarray(
                b['proposal_scale_factor'], np.float64)
        with jax.enable_x64(True):
            jax_model = jax_build_model(
                dict(cfg, backbone=dict(cfg['backbone'],
                                        dtype=jnp.float64)),
                train_cfg=TRAIN_CFG)
            prepare, _ = JAX_KINDS[kind]
            jax_tensors = [prepare(jax_model, b) for b in batches]
            variables = _ssn_variables(jax_model, jax_tensors[0],
                                       np.float64)
            opt_cfg, dtype, tol = SSN_ADAM, torch.float64, F64_TOL
            losses, start, final, draws = _jax_steps(
                kind, jax_model, jax_tensors, variables, opt_cfg)

    model = carried(cfg, variables, dtype, train_cfg=TRAIN_CFG).train()
    optimizer, _ = build_optimizer(model.parameters(), opt_cfg, None, 10)
    port_step = make_localizer_train_step(model, optimizer)
    ours_losses = [float(port_step(prepare_batch(model, b, 'cpu'),
                                   draws=d if kind == 'BMN' else None)[
                                       'loss'])
                   for b, d in zip(batches, draws)]
    np.testing.assert_allclose(ours_losses, losses, rtol=tol)
    names = sorted(final)
    ours = _flat(model.state_dict(), names) - _flat(start, names)
    ref = _flat(final, names) - _flat(start, names)
    err = float(torch.linalg.norm(ours - ref) / torch.linalg.norm(ref))
    assert err <= tol, err


def _train_cfg(model, data, work, **extra):
    return Config(dict(model=model, data=data, optimizer=dict(ADAM),
                       total_epochs=1, work_dir=work, **extra))


@pytest.mark.parametrize('kind', ['BMN', 'TEM', 'PEM', 'SSN'])
def test_train_localizer_model_trains_and_validates(kind, tmp_path):
    """The config -> loop path (as ``tools.train`` dispatches it): one
    epoch, a checkpoint, a finite val loss logged as ``mode='val'``; a
    second call with ``total_epochs=2`` resumes from ``epoch_1``."""
    root = str(tmp_path)
    model_cfg, data_cfg, batch = {
        'BMN': (BMN_CFG, lambda: _anet_cfg(root), 2),
        'TEM': (TEM_CFG, lambda: _anet_cfg(root), 2),
        'PEM': (PEM_CFG, lambda: _pem_cfg(root), 2),
        'SSN': (SSN_CFG, lambda: _ssn_cfg(root), 1)}[kind]
    data_cfg = data_cfg()
    work = str(tmp_path / 'work')
    cfg = _train_cfg(model_cfg, dict(videos_per_gpu=batch,
                                     workers_per_gpu=0, val=data_cfg), work)
    dataset = build_dataset(data_cfg)
    state = train_localizer_model(
        build_model(cfg.model, train_cfg=TRAIN_CFG), dataset, cfg,
        validate=True, device='cpu')
    steps = len(dataset) // batch
    assert state.step == steps
    assert os.path.isfile(osp.join(work, 'checkpoints', 'epoch_1'))
    with open(osp.join(work, 'train_log.jsonl')) as f:
        log = [json.loads(line) for line in f]
    val = [e for e in log if e['mode'] == 'val']
    assert val and np.isfinite(val[-1]['loss'])
    assert all(np.isfinite(e['loss']) for e in log if e['mode'] == 'train')
    cfg.total_epochs = 2
    state = train_localizer_model(
        build_model(cfg.model, train_cfg=TRAIN_CFG), dataset, cfg,
        device='cpu')
    assert state.step == 2 * steps


def test_train_localizer_model_wiring(tmp_path):
    """As ``test_core/test_localization_train.py``'s wiring test: TEM on
    four videos in batches of 2 ends at step 2 with a checkpoint."""
    data_cfg = _anet_cfg(str(tmp_path), FEATURE_PIPELINE[:2])
    cfg = _train_cfg(TEM_CFG, dict(videos_per_gpu=2, workers_per_gpu=0),
                     str(tmp_path / 'work'))
    state = train_localizer_model(build_model(cfg.model),
                                  build_dataset(data_cfg), cfg,
                                  device='cpu')
    assert state.step == 2
    assert os.listdir(str(tmp_path / 'work' / 'checkpoints'))


def _write_config(path, **cfg):
    with open(path, 'w') as f:
        f.writelines(f'{k} = {v!r}\n' for k, v in cfg.items())
    return str(path)


@pytest.mark.parametrize('kind', ['BMN', 'PEM'])
def test_train_cli_trains_a_localizer_config(kind, tmp_path):
    """``python -m vfs_tpu_torch.tools.train`` on a localizer config:
    trains, writes ``epoch_1``; ``--auto-resume`` with two epochs carries
    on from it."""
    root = str(tmp_path)
    model_cfg, data_cfg = {'BMN': (BMN_CFG, _anet_cfg),
                           'PEM': (PEM_CFG, _pem_cfg)}[kind]
    config = _write_config(
        tmp_path / 'cfg.py', model=model_cfg,
        data=dict(videos_per_gpu=2, workers_per_gpu=1,
                  train=data_cfg(root)),
        optimizer=ADAM, total_epochs=1, log_config=dict(interval=1))
    work = str(tmp_path / 'w')
    args = [config, '--work-dir', work, '--device', 'cpu']
    assert tools_train.main(args).step == 2
    assert os.path.isfile(osp.join(work, 'checkpoints', 'epoch_1'))
    state = tools_train.main(args + ['--auto-resume', '--options',
                                     'total_epochs=2'])
    assert state.step == 4


def test_tsn_feature_extraction_matches_jax_recognizer(tmp_path,
                                                       monkeypatch):
    """``tools.data.tsn_feature_extraction`` on rawframes: its pickled
    scores equal the JAX ``Recognizer2D`` (ResNet-50 + TSNHead) on the
    same snippets with the same weights (rtol / atol 1e-4: fp32 through
    fifty layers)."""
    import cv2

    from vfs_tpu.datasets.pipelines import Compose as JaxCompose
    from vfs_tpu_torch.checkpoint import flax_recognizer_to_torch
    from vfs_tpu_torch.tools.data import tsn_feature_extraction as tsn
    rng = np.random.RandomState(0)
    frames = tmp_path / 'frames' / 'vid'
    frames.mkdir(parents=True)
    for i in range(1, 9):
        cv2.imwrite(str(frames / f'img_{i:05d}.jpg'),
                    rng.randint(0, 255, (40, 48, 3), np.uint8))
    data_list = tmp_path / 'list.txt'
    data_list.write_text('vid 8 vid.pkl\n')
    argv = ['--data-prefix', str(tmp_path / 'frames'), '--output-prefix',
            str(tmp_path / 'out'), '--data-list', str(data_list),
            '--frame-interval', '2', '--num-classes', '5', '--batch-size',
            '3', '--device', 'cpu']
    monkeypatch.setattr(tsn, 'CROP', 32)
    jax_model = jax_build_model(dict(
        type='Recognizer2D', backbone=dict(type='ResNet', depth=50),
        cls_head=dict(type='TSNHead', num_classes=5, in_channels=2048,
                      spatial_type='avg',
                      consensus=dict(type='AvgConsensus', dim=1))),
        test_cfg=dict(average_clips=None))
    pipeline = JaxCompose([
        dict(type='UntrimmedSampleFrames', clip_len=1, frame_interval=2),
        dict(type='RawFrameDecode'), dict(type='Resize', scale=(-1, 32)),
        dict(type='CenterCrop', crop_size=32),
        dict(type='Normalize', mean=tsn.MEAN, std=tsn.STD),
        dict(type='FormatShape', input_format='NHWC'),
        dict(type='Collect', keys=['imgs'], meta_keys=[])])
    imgs = np.asarray(pipeline(dict(
        frame_dir=str(frames), total_frames=8, filename_tmpl='img_{:05d}.jpg',
        start_index=1, modality='RGB'))['imgs'])[:, None]
    variables = jax_variables(jax_model, jnp.asarray(imgs), train=False,
                              return_loss=False)
    ref = np.asarray(jax_model.apply(variables, jnp.asarray(imgs),
                                     train=False, return_loss=False))
    build = tsn.build_extractor

    def carried_extractor(num_classes, ckpt, device):
        model = build(num_classes, ckpt, device)
        model.load_state_dict(flax_recognizer_to_torch(
            variables['params'], variables['batch_stats']), strict=False)
        return model.eval()

    monkeypatch.setattr(tsn, 'build_extractor', carried_extractor)
    written = tsn.main(argv)
    with open(written[0], 'rb') as f:
        feat = pickle.load(f)
    assert feat.shape == (4, 5)
    np.testing.assert_allclose(feat, ref, rtol=1e-4, atol=1e-4)


def test_localizer_entry_points_raise_without_gpu(tmp_path, monkeypatch):
    from vfs_tpu_torch.tools.data import tsn_feature_extraction as tsn
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    cfg = _train_cfg(TEM_CFG, dict(videos_per_gpu=2, workers_per_gpu=0),
                     str(tmp_path / 'work'))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_localizer_model(build_model(cfg.model), build_dataset(
            _anet_cfg(str(tmp_path), FEATURE_PIPELINE[:2])), cfg)
    (tmp_path / 'list.txt').write_text('')
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsn.main(['--data-list', str(tmp_path / 'list.txt')])


def test_tsn_feature_extraction_loads_its_checkpoint(tmp_path):
    """``--ckpt``, a torchvision-layout ResNet-50 ``.pth``, goes into the
    extractor's backbone (the JAX tool passes it as ``pretrained``, which
    its ResNet does not read, and extracts with random weights: ROADMAP
    Queue 3)."""
    from vfs_tpu_torch.models import build_backbone
    from vfs_tpu_torch.tools.data import tsn_feature_extraction as tsn
    backbone = build_backbone(dict(type='ResNet', depth=50))
    backbone.init_weights(torch.Generator().manual_seed(5))
    path = str(tmp_path / 'r50.pth')
    torch.save(backbone.state_dict(), path)
    loaded = tsn.build_extractor(5, path, 'cpu').backbone.state_dict()
    seeded = tsn.build_extractor(5, None, 'cpu').backbone.state_dict()
    for name, value in backbone.state_dict().items():
        assert torch.equal(loaded[name], value), name
    assert not torch.equal(seeded['conv1.weight'],
                           loaded['conv1.weight'])
