"""Training recognizers in the port against the JAX package: two train
steps of ``Recognizer2D`` (``ResNetTSM`` r18 + ``TSMHead``) and of
``Recognizer3D`` (``ResNet3d`` r18 + ``I3DHead``) in float64, through
each package's ``make_train_step`` with the labels path, from the same
weights (``flax_recognizer_to_torch``) on the same clips and labels: every
parameter update and running statistic within 1e-9 of the JAX one in
relative L2 (plus 1e-12), the losses within 1e-9. Dropout is 0 here: torch
cannot draw flax's bits; the port's dropout is held apart
(``test_torch_recognition.py``: rate, scale, seeding) and here its seeding
by step. The JAX ``ResNetTSM`` builds its ``ConvBN`` without a dtype (fp32
compute), so its float64 run swaps in a float64 ``ConvBN`` for the test;
``ResNet3d`` takes ``dtype=float64``.

Also here: ``tsm_param_labels`` against the JAX labels for every carried
parameter of several recognizers, two ``build_tsm_optimizer`` steps
against optax's ``multi_transform``, ``CopyOfSGD`` against its optax
chain, ``train_model`` end to end on
rawframes (the loss falls; ``tests/test_models/test_recognizer_train.py``
on the port), the train CLI on a recognizer config, and the entry points'
refusal to run without a GPU unless asked for the CPU.
"""

import functools
import json
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vfs_tpu.models.backbones.resnet_tsm as jax_resnet_tsm
from vfs_tpu.apis.train import TrainState as JaxTrainState
from vfs_tpu.apis.train import make_train_step as jax_make_train_step
from vfs_tpu.core.optimizer import build_optimizer as jax_build_optimizer
from vfs_tpu.core.optimizer import \
    build_tsm_optimizer as jax_build_tsm_optimizer
from vfs_tpu.core.optimizer import tsm_param_labels as jax_tsm_param_labels
from vfs_tpu.models import build_model as jax_build_model
from vfs_tpu.models.backbones.resnet import ConvBN as JaxConvBN
from vfs_tpu_torch.apis.train import (DROPOUT_STREAM, make_train_step,
                                      model_takes_labels, train_model)
from vfs_tpu_torch.checkpoint import flax_recognizer_to_torch
from vfs_tpu_torch.core.optimizer import (build_optimizer,
                                          build_tsm_optimizer,
                                          tsm_param_labels)
from vfs_tpu_torch.datasets import build_dataset
from vfs_tpu_torch.models import build_model
from vfs_tpu_torch.ops.device_aug import step_seed
from vfs_tpu_torch.tools import train as tools_train
from vfs_tpu_torch.utils import Config

from test_models.test_recognizer_train import make_rawframes
from test_torch_recognition import frames, jax_variables, load_port

torch.set_num_threads(1)

TSM_CFG = dict(type='Recognizer2D',
               backbone=dict(type='ResNetTSM', depth=18, num_segments=2),
               cls_head=dict(type='TSMHead', num_classes=4, in_channels=512,
                             num_segments=2, dropout_ratio=0.0))
I3D_CFG = dict(type='Recognizer3D',
               backbone=dict(type='ResNet3d', depth=18, base_channels=16,
                             conv1_kernel=(3, 7, 7), conv1_stride_t=1,
                             pool1_stride_t=1),
               cls_head=dict(type='I3DHead', num_classes=4, in_channels=128,
                             dropout_ratio=0.0))
# (config, batch shape, labels): 4 clips of 2 segments / one 4-frame clip
CASES = {'tsm': (TSM_CFG, (4, 2, 32, 32, 3), [0, 3, 1, 2]),
         'i3d': (I3D_CFG, (4, 1, 4, 32, 32, 3), [2, 0, 3, 1])}
OPT_CFG = dict(type='SGD', lr=0.05, momentum=0.9, weight_decay=1e-4)
LR_CFG = dict(policy='CosineAnnealing', min_lr=0, by_epoch=False)
TOTAL_ITERS = 10


def _jax_model_f64(cfg, monkeypatch):
    """The JAX recognizer computing in float64 (module docstring)."""
    if cfg['backbone']['type'] == 'ResNet3d':
        cfg = dict(cfg, backbone=dict(cfg['backbone'], dtype=jnp.float64))
    else:
        monkeypatch.setattr(jax_resnet_tsm, 'ConvBN', functools.partial(
            JaxConvBN, dtype=jnp.float64))
    return jax_build_model(cfg)


def _batches(shape, n=2):
    return [frames(*shape, seed=10 + i).astype(np.float64) for i in range(n)]


def _jax_steps(name, monkeypatch, tsm_optimizer=False):
    """(start variables, [losses], final variables) of two JAX steps."""
    cfg, shape, labels = CASES[name]
    with jax.enable_x64(True):
        model = _jax_model_f64(cfg, monkeypatch)
        xs = _batches(shape)
        variables = jax_variables(model, xs[0], jnp.asarray(labels),
                                  train=True, dtype=np.float64)
        params = variables['params']
        if tsm_optimizer:
            tx = jax_build_tsm_optimizer(params, 0.05, 0.9, 1e-4)
        else:
            tx, _ = jax_build_optimizer(OPT_CFG, LR_CFG, TOTAL_ITERS, 5)
        state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                              batch_stats=variables['batch_stats'],
                              opt_state=tx.init(params))
        step = jax.jit(jax_make_train_step(model, tx))
        losses = []
        for x in xs:
            state, log_vars = step(state, jnp.asarray(x),
                                   jnp.asarray(labels))
            losses.append(float(log_vars['loss']))
        final = jax.tree.map(np.asarray, dict(
            params=state.params, batch_stats=state.batch_stats))
    return variables, losses, final


def _port_steps(name, variables, tsm_optimizer=False):
    cfg, shape, labels = CASES[name]
    model = load_port(build_model(cfg).double(), variables).train()
    if tsm_optimizer:
        optimizer = build_tsm_optimizer(model, 0.05, 0.9, 1e-4)
    else:
        optimizer, _ = build_optimizer(model.parameters(), OPT_CFG, LR_CFG,
                                       TOTAL_ITERS, 5)
    step = make_train_step(model, optimizer)
    losses = [float(step(x, None, np.asarray(labels))['loss'])
              for x in _batches(shape)]
    return model, losses


def _assert_updates_equal(model, start, final):
    start_sd = flax_recognizer_to_torch(start['params'],
                                        start['batch_stats'])
    final_sd = flax_recognizer_to_torch(final['params'],
                                        final['batch_stats'])
    sd = model.state_dict()
    assert set(final_sd) <= set(sd)
    for name in final_sd:
        ours = sd[name] - start_sd[name]
        ref = final_sd[name] - start_sd[name]
        err = float(torch.linalg.norm(ours - ref))
        assert err <= 1e-9 * float(torch.linalg.norm(ref)) + 1e-12, \
            (name, err)


@pytest.mark.parametrize('name', list(CASES))
def test_two_train_steps_match_jax_in_float64(name, monkeypatch):
    """The labelled step's loss, gradient, SGD chain, schedule and
    BatchNorm statistics are the JAX package's."""
    start, jax_losses, final = _jax_steps(name, monkeypatch)
    model, losses = _port_steps(name, start)
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-9)
    _assert_updates_equal(model, start, final)


def test_two_tsm_optimizer_steps_match_optax(monkeypatch):
    """``build_tsm_optimizer``'s groups (first conv, BatchNorm, fc_cls 5x
    lr and 10x decay, biases 2x lr without decay) over two steps equal
    optax's ``multi_transform``."""
    start, jax_losses, final = _jax_steps('tsm', monkeypatch,
                                          tsm_optimizer=True)
    model, losses = _port_steps('tsm', start, tsm_optimizer=True)
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-9)
    _assert_updates_equal(model, start, final)


@pytest.mark.parametrize('nesterov', [False, True])
def test_copy_of_sgd_matches_optax(nesterov):
    """``CopyOfSGD``, the reference's registered SGD clone: three updates
    equal to the JAX package's optax chain in float64."""
    import optax

    from vfs_tpu.core.optimizer import CopyOfSGD as JaxCopyOfSGD
    from vfs_tpu_torch.core.optimizer import CopyOfSGD
    rng = np.random.RandomState(7)
    start = rng.randn(5, 3)
    grads = [rng.randn(5, 3) for _ in range(3)]
    with jax.enable_x64(True):
        tx = JaxCopyOfSGD(0.1, momentum=0.9, weight_decay=1e-2,
                          nesterov=nesterov)
        params = jnp.asarray(start)
        state = tx.init(params)
        for g in grads:
            updates, state = tx.update(jnp.asarray(g), state, params)
            params = optax.apply_updates(params, updates)
        ref = np.asarray(params)
    p = torch.tensor(start, requires_grad=True)
    optimizer = CopyOfSGD([p], 0.1, momentum=0.9, weight_decay=1e-2,
                          nesterov=nesterov)
    for g in grads:
        p.grad = torch.from_numpy(g)
        optimizer.step()
    np.testing.assert_allclose(p.detach().numpy(), ref, rtol=1e-12)


LABEL_CASES = {
    'tsm_non_local': (dict(
        type='Recognizer2D',
        backbone=dict(type='ResNetTSM', depth=18, num_segments=2,
                      non_local=((0, 0), (0, 1), 0, 0),
                      non_local_cfg=dict(norm_cfg=dict(type='BN3d'))),
        cls_head=dict(type='TSMHead', num_classes=4, in_channels=512,
                      num_segments=2)), (1, 2, 32, 32, 3)),
    'tin': (dict(type='Recognizer2D',
                 backbone=dict(type='ResNetTIN', depth=18, num_segments=2),
                 cls_head=dict(type='TSMHead', num_classes=4,
                               in_channels=512, num_segments=2)),
            (1, 2, 32, 32, 3)),
    'slowfast': (dict(
        type='Recognizer3D',
        backbone=dict(type='ResNet3dSlowFast', resample_rate=4,
                      speed_ratio=4,
                      slow_pathway=dict(depth=18, lateral=True,
                                        conv1_kernel=(1, 7, 7),
                                        inflate=(0, 0, 1, 1)),
                      fast_pathway=dict(depth=18, lateral=False,
                                        base_channels=8,
                                        conv1_kernel=(5, 7, 7))),
        cls_head=dict(type='SlowFastHead', num_classes=4,
                      in_channels=576)), (1, 1, 8, 32, 32, 3)),
    'r2plus1d': (dict(type='Recognizer3D',
                      backbone=dict(type='ResNet2Plus1d', depth=18),
                      cls_head=dict(type='I3DHead', num_classes=4,
                                    in_channels=512)),
                 (1, 1, 8, 32, 32, 3)),
}


@pytest.mark.parametrize('fc_lr5', [True, False])
@pytest.mark.parametrize('name', list(LABEL_CASES))
def test_tsm_param_labels_match_jax(name, fc_lr5):
    """Each carried parameter takes its flax counterpart's group: every
    leaf of the JAX tree becomes an array of its index, carried to its
    torch name."""
    cfg, shape = LABEL_CASES[name]
    jmodel = jax_build_model(cfg)
    x = np.zeros(shape, np.float32)
    params = jax_variables(jmodel, x, train=False,
                           return_loss=False)['params']
    flat, treedef = jax.tree_util.tree_flatten(params)
    index = jax.tree_util.tree_unflatten(
        treedef, [np.full(a.shape, i, np.float64)
                  for i, a in enumerate(flat)])
    jax_labels = jax.tree_util.tree_leaves(
        jax_tsm_param_labels(params, fc_lr5=fc_lr5))
    names = {k: int(v.flatten()[0])
             for k, v in flax_recognizer_to_torch(index, {}).items()}
    ours = tsm_param_labels(build_model(cfg), fc_lr5=fc_lr5)
    assert set(ours) == set(names)
    for k, label in ours.items():
        assert label == jax_labels[names[k]], k
    assert set(ours.values()) >= {'bn', 'first_conv_weight',
                                  'normal_weight'}


def test_dropout_draws_are_seeded_by_step():
    """The labelled step seeds the heads' dropout from (seed, rank, step,
    DROPOUT_STREAM): at a given update count a resumed run draws what an
    uninterrupted one does, and successive steps draw apart."""
    cfg = dict(TSM_CFG, cls_head=dict(TSM_CFG['cls_head'],
                                      dropout_ratio=0.5))
    masks = []

    def record(module, args, out):
        masks.append(out.detach().clone())

    def run(count):
        model = build_model(cfg)
        model.init_weights(torch.Generator().manual_seed(0))
        model.cls_head.fc_cls.register_forward_hook(record)
        optimizer, _ = build_optimizer(model.parameters(), OPT_CFG)
        optimizer.count = count
        make_train_step(model.train(), optimizer, seed=3)(
            frames(2, 2, 32, 32, 3), None, np.array([0, 1]))

    assert model_takes_labels(build_model(cfg))
    run(5)
    run(5)
    run(6)
    assert torch.equal(masks[0], masks[1])
    assert not torch.equal(masks[0], masks[2])
    assert step_seed(3, 0, 5, DROPOUT_STREAM) != step_seed(3, 0, 5)


def _rawframes_cfg(tmp_path, model, total_epochs=4, **extra):
    ann = make_rawframes(str(tmp_path / 'frames'))
    pipeline = [
        dict(type='SampleFrames', clip_len=1, frame_interval=0, num_clips=2,
             out_of_bound_opt='loop'),
        dict(type='RawFrameDecode'),
        dict(type='Resize', scale=(32, 32), keep_ratio=False),
        dict(type='Normalize', mean=[123.675, 116.28, 103.53],
             std=[58.395, 57.12, 57.375]),
        dict(type='FormatShape', input_format='NCHW'),
        dict(type='Collect', keys=['imgs', 'label'], meta_keys=[]),
    ]
    return dict(
        work_dir=str(tmp_path / 'work'), seed=0, model=model,
        test_cfg=dict(average_clips=None),
        data=dict(videos_per_gpu=4, workers_per_gpu=1,
                  train=dict(type='RawframeDataset', ann_file=ann,
                             data_prefix=str(tmp_path / 'frames'),
                             pipeline=pipeline)),
        optimizer=dict(type='SGD', lr=0.05, momentum=0.9),
        optimizer_config=dict(grad_clip=None),
        lr_config=dict(policy='CosineAnnealing', min_lr=0, by_epoch=False),
        total_epochs=total_epochs, checkpoint_config=dict(interval=10),
        log_config=dict(interval=1), **extra)


TSN_CFG = dict(type='Recognizer2D', backbone=dict(type='ResNet', depth=18),
               cls_head=dict(type='TSNHead', num_classes=2, in_channels=512,
                             dropout_ratio=0.4))


def test_train_model_recognizer_loss_falls(tmp_path):
    """tests/test_models/test_recognizer_train.py on the port: a TSN
    (ResNet-18, dropout 0.4) on a separable-by-colour rawframe set; the
    last losses below the first."""
    cfg = Config.fromdict(_rawframes_cfg(tmp_path, TSN_CFG))
    dataset = build_dataset(cfg.data.train)
    model = build_model(cfg.model, test_cfg=cfg.test_cfg)
    state = train_model(model, dataset, cfg, device='cpu')
    assert state.step == 8
    records = [json.loads(ln) for ln in
               open(tmp_path / 'work' / 'train_log.jsonl')]
    losses = [r['loss_cls'] for r in records if 'loss_cls' in r]
    assert len(losses) == 8 and all(np.isfinite(losses))
    assert np.mean(losses[-2:]) < np.mean(losses[:2])


def test_train_cli_takes_a_tsm_config_with_its_optimizer(tmp_path,
                                                         monkeypatch):
    """``tools.train`` on a TSM config with MMAction2's
    ``TSMOptimizerConstructor`` (the TSM groups), then a resume; without
    a GPU and without ``--device cpu`` it raises."""
    model = dict(type='Recognizer2D',
                 backbone=dict(type='ResNetTSM', depth=18, num_segments=2),
                 cls_head=dict(type='TSMHead', num_classes=2,
                               in_channels=512, num_segments=2))
    cfg = _rawframes_cfg(tmp_path, model, total_epochs=1)
    cfg['optimizer'] = dict(type='SGD', constructor='TSMOptimizerConstructor',
                            paramwise_cfg=dict(fc_lr5=True), lr=0.01,
                            momentum=0.9, weight_decay=1e-4)
    work = cfg.pop('work_dir')
    path = tmp_path / 'tsm.py'
    path.write_text(''.join(f'{k} = {v!r}\n' for k, v in cfg.items()))
    state = tools_train.main([str(path), '--work-dir', work, '--device',
                              'cpu'])
    assert state.step == 2
    assert [lr for lr, _ in state.optimizer.mults[-2:]] == [5.0, 10.0]
    assert osp.isfile(osp.join(work, 'checkpoints', 'epoch_1'))
    state = tools_train.main([str(path), '--work-dir', work, '--device',
                              'cpu', '--auto-resume', '--options',
                              'total_epochs=2'])
    assert state.step == 4
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tools_train.main([str(path), '--work-dir', work])
