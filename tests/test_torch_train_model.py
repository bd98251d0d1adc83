"""``train_model`` and ``python -m vfs_tpu_torch.tools.train`` on the CPU
(``device='cpu'`` / ``--device cpu``), mirroring
``tests/test_models/test_simsiam_train.py`` and
``tests/test_models/test_train_validate.py``: two epochs on
``make_video_dataset``'s videos, checkpoints, auto-resume, the DAVIS eval
hook on ``make_mini_davis`` with ``best.json``; the eval hand-off against
the JAX package's (same backbone weights, every metric within 1e-4); two
processes under torchrun's environment; ``--profile``, ``cfg.device_aug``
through the CLI and the wandb logger (a fake ``wandb`` module, against the
JAX package's logger); the keys left for later slices; the CLI's refusal
to run without a GPU unless asked for the CPU.
"""

import json
import os
import os.path as osp
import runpy
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from vfs_tpu.apis.train import build_val_eval_fn as jax_build_val_eval_fn
from vfs_tpu.models import build_model as jax_build_model
from vfs_tpu.utils import Config as JaxConfig
from vfs_tpu_torch.apis.train import build_val_eval_fn, train_model
from vfs_tpu_torch.checkpoint import flax_simsiam_to_torch
from vfs_tpu_torch.core.evaluation import EvalHook
from vfs_tpu_torch.datasets import build_dataset
from vfs_tpu_torch.models import build_model
from vfs_tpu_torch.tools import train as tools_train
from vfs_tpu_torch.utils import Config, JsonlLogger

from test_data.test_davis_e2e import VAL_PIPELINE, make_mini_davis
from test_models.test_simsiam_train import make_video_dataset
from test_torch_train_data import train_pipeline
from test_torch_train_step import MODEL_CFG, TRAIN_CFG, jax_variables

torch.set_num_threads(1)

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
TEST_CFG = dict(precede_frames=3, topk=5, temperature=0.07,
                strides=(1, 2, 1, 1), out_indices=(2,), neighbor_range=12,
                batch_step=3)


@pytest.fixture(scope='module')
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp('train_data')
    ann = make_video_dataset(str(root / 'videos'), num_videos=4,
                             num_frames=8, hw=(48, 64))
    davis = make_mini_davis(str(root / 'davis'), num_videos=1, num_frames=6)
    return ann, davis, root


def _cfg_dict(data, work_dir, total_epochs=2):
    ann, (davis_ann, img_root, ann_root), root = data
    return dict(
        model=MODEL_CFG, train_cfg=TRAIN_CFG, test_cfg=TEST_CFG,
        work_dir=str(work_dir), seed=0,
        data=dict(
            videos_per_gpu=4, workers_per_gpu=1,
            train=dict(type='RepeatDataset', times=2, dataset=dict(
                type='VideoDataset', ann_file=ann,
                data_prefix=osp.dirname(ann), pipeline=train_pipeline())),
            val=dict(type='DavisDataset', ann_file=davis_ann,
                     data_prefix=img_root, anno_prefix=ann_root,
                     data_root=str(root / 'davis'), pipeline=VAL_PIPELINE,
                     test_mode=True)),
        optimizer=dict(type='SGD', lr=0.05, momentum=0.9,
                       weight_decay=1e-4),
        optimizer_config=dict(grad_clip=None),
        lr_config=dict(policy='CosineAnnealing', min_lr=0, by_epoch=False),
        total_epochs=total_epochs, checkpoint_config=dict(interval=1),
        log_config=dict(interval=1),
        evaluation=dict(interval=1, metrics='davis',
                        key_indicator='J&F-Mean', rule='greater'))


def test_train_model_checkpoints_resumes_and_validates(data, tmp_path):
    cfg = Config.fromdict(_cfg_dict(data, tmp_path / 'work'))
    dataset = build_dataset(cfg.data.train)
    assert len(dataset) == 8
    model = build_model(cfg.model, train_cfg=cfg.train_cfg)
    state = train_model(model, dataset, cfg, validate=True, device='cpu')
    assert state.step == 4  # 8 samples / 4 = 2 steps x 2 epochs
    ckpt = tmp_path / 'work' / 'checkpoints'
    assert (ckpt / 'epoch_1').is_file() and (ckpt / 'epoch_2').is_file()
    assert (ckpt / 'latest').read_text() == 'epoch_2'
    saved = torch.load(ckpt / 'epoch_2', weights_only=True)
    assert saved['step'] == 4 and saved['epoch'] == 2
    for k, v in model.state_dict().items():
        assert torch.equal(saved['model'][k], v), k
    best = json.loads((tmp_path / 'work' / 'best.json').read_text())
    assert best['key_indicator'] == 'J&F-Mean'
    assert 0.0 <= best['best_score'] <= 1.0
    lines = [json.loads(ln) for ln in
             (tmp_path / 'work' / 'train_log.jsonl').read_text().split('\n')
             if ln]
    train_lines = [r for r in lines if r['mode'] == 'train']
    assert len(train_lines) == 4
    assert all(np.isfinite(r['loss']) for r in train_lines)
    assert sum(r['mode'] == 'val' for r in lines) == 2

    # auto-resume: a longer run continues from epoch 2 and runs epoch 3
    cfg3 = Config.fromdict(_cfg_dict(data, tmp_path / 'work', 3))
    model3 = build_model(cfg3.model, train_cfg=cfg3.train_cfg)
    state3 = train_model(model3, dataset, cfg3, device='cpu')
    assert state3.step == 6
    assert (ckpt / 'latest').read_text() == 'epoch_3'
    resumed = torch.load(ckpt / 'epoch_3', weights_only=True)
    assert not torch.equal(resumed['model']['backbone.conv1.weight'],
                           saved['model']['backbone.conv1.weight'])


def test_eval_hand_off_matches_jax(data, tmp_path):
    """The train model's backbone weights go into the eval tracker: the
    same weights give the JAX package's J&F; renamed keys raise."""
    cfg_dict = _cfg_dict(data, tmp_path / 'work')
    jax_model = jax_build_model(MODEL_CFG, train_cfg=TRAIN_CFG)
    params, stats = jax_variables(
        jax_model, np.zeros((1, 2, 2, 32, 32, 3), np.float32))

    class JaxState:
        pass
    JaxState.params, JaxState.batch_stats = params, stats
    ref = jax_build_val_eval_fn(JaxConfig.fromdict(cfg_dict),
                                lambda: JaxState)()
    model = build_model(MODEL_CFG, train_cfg=TRAIN_CFG)
    model.load_state_dict(flax_simsiam_to_torch(params, stats),
                          strict=False)
    cfg = Config.fromdict(cfg_dict)
    out = build_val_eval_fn(cfg, lambda: model, device='cpu')()
    assert set(out) == set(ref)
    for k in ref:
        assert out[k] == pytest.approx(float(ref[k]), abs=1e-4), k

    class Renamed(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.net = model.backbone
    with pytest.raises(KeyError, match='backbone'):
        build_val_eval_fn(cfg, Renamed, device='cpu')()


def _write_config(fixture, tmp_path, **extra):
    cfg = _cfg_dict(fixture, tmp_path / 'unused')
    cfg.pop('work_dir')
    cfg.update(extra)
    path = tmp_path / 'cfg.py'
    path.write_text(''.join(f'{k} = {v!r}\n' for k, v in cfg.items()))
    return str(path)


def test_tools_train_cli_on_cpu_and_no_gpu(data, tmp_path, monkeypatch):
    config = _write_config(data, tmp_path)
    work = str(tmp_path / 'cli')
    state = tools_train.main([config, '--work-dir', work, '--device', 'cpu',
                              '--validate', '--auto-resume',
                              '--compilation-cache', '/nonexistent'])
    assert state.step == 4
    assert osp.isfile(osp.join(work, 'best.json'))
    assert osp.isfile(osp.join(work, 'cfg.py'))
    state = tools_train.main([config, '--work-dir', work, '--device', 'cpu',
                              '--auto-resume', '--options',
                              'total_epochs=3'])
    assert state.step == 6
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tools_train.main([config, '--work-dir', work])


def _r50_extra():
    """configs/r50_nc_sgd_cos_100e_r5_1xNx2_k400.py at a test size: its
    tracker (ResNet-50, ``zero_init_residual``, ``intra_video=False``)
    with a narrow head, and its train pipeline (DecordInit, 2 clips of
    ``clip_len`` 1, RandomResizedCrop, Flip) resized to 32x32."""
    from test_torch_train_step_r50 import MODEL_CFG as R50_MODEL_CFG
    r50 = runpy.run_path(osp.join(ROOT, 'configs',
                                  'r50_nc_sgd_cos_100e_r5_1xNx2_k400.py'))
    pipeline = [dict(step, scale=(32, 32)) if step['type'] == 'Resize'
                else dict(step) for step in r50['train_pipeline']]
    assert [s['type'] for s in pipeline][:3] == [
        'DecordInit', 'SampleFrames', 'DecordDecode']
    assert pipeline[1]['clip_len'] == 1 and pipeline[1]['num_clips'] == 2
    return dict(model=R50_MODEL_CFG, train_cfg=dict(r50['train_cfg'])), \
        pipeline


def test_tools_train_r50_config_on_cpu(data, tmp_path):
    """The r50 pretraining config through ``python -m
    vfs_tpu_torch.tools.train --device cpu --validate --auto-resume``: two
    epochs of two steps with the DAVIS hook (layer3's 1024 channels),
    ``best.json``, then a resume that runs epoch 3 alone."""
    extra, pipeline = _r50_extra()
    cfg = _cfg_dict(data, tmp_path / 'unused')
    cfg['data']['train']['dataset']['pipeline'] = pipeline
    config = _write_config(data, tmp_path, data=cfg['data'], **extra)
    work = str(tmp_path / 'r50')
    state = tools_train.main([config, '--work-dir', work, '--device', 'cpu',
                              '--validate', '--auto-resume'])
    assert state.step == 4
    with open(osp.join(work, 'best.json')) as f:
        assert 0.0 <= json.load(f)['best_score'] <= 1.0
    with open(osp.join(work, 'train_log.jsonl')) as f:
        lines = [json.loads(ln) for ln in f if ln.strip()]
    train_lines = [r for r in lines if r['mode'] == 'train']
    assert len(train_lines) == 4
    assert all(np.isfinite(r['loss']) for r in train_lines)
    assert sum(r['mode'] == 'val' for r in lines) == 2
    state = tools_train.main([config, '--work-dir', work, '--device', 'cpu',
                              '--auto-resume', '--options',
                              'total_epochs=3'])
    assert state.step == 6
    assert sorted(os.listdir(osp.join(work, 'checkpoints'))) == [
        'epoch_1', 'epoch_2', 'epoch_3', 'latest']
    saved = torch.load(osp.join(work, 'checkpoints', 'epoch_3'),
                       weights_only=True)
    assert saved['model']['backbone.layer4.2.bn3.weight'].shape == (2048,)


RECOGNIZER_CFG = dict(
    type='Recognizer2D',
    backbone=dict(type='ResNetTSM', depth=18, num_segments=2),
    cls_head=dict(type='TSMHead', num_classes=2, in_channels=512,
                  num_segments=2))


def _recognizer_data(data):
    """The fixture's clips through a recognition pipeline: 2 segments of
    32x32 frames and each clip's label."""
    ann = data[0]
    pipeline = [
        dict(type='OpenCVInit'),
        dict(type='SampleFrames', clip_len=1, frame_interval=1,
             num_clips=2),
        dict(type='OpenCVDecode'),
        dict(type='Resize', scale=(32, 32), keep_ratio=False),
        dict(type='Normalize', mean=[123.675, 116.28, 103.53],
             std=[58.395, 57.12, 57.375]),
        dict(type='FormatShape', input_format='NCHW'),
        dict(type='Collect', keys=['imgs', 'label'], meta_keys=[])]
    return dict(videos_per_gpu=2, workers_per_gpu=1, train=dict(
        type='VideoDataset', ann_file=ann, data_prefix=osp.dirname(ann),
        pipeline=pipeline))


def _localizer_extra(tmp_path):
    """A TEM config's model and data on the ActivityNet-layout fixture of
    the JAX tests (4 videos of 20 x 8 features, batches of 2)."""
    from test_core.test_localization_train import make_activitynet
    root = str(tmp_path / 'anet')
    return dict(
        model=dict(type='TEM', temporal_dim=20, boundary_ratio=0.1,
                   tem_feat_dim=8, tem_hidden_dim=32,
                   tem_match_threshold=0.5),
        data=dict(videos_per_gpu=2, workers_per_gpu=1, train=dict(
            type='ActivityNetDataset', ann_file=make_activitynet(root),
            data_prefix=root, pipeline=[
                dict(type='LoadLocalizationFeature'),
                dict(type='GenerateLocalizationLabels')])),
        optimizer=dict(type='Adam', lr=0.001), lr_config=None)


@pytest.mark.parametrize('argv,extra,item', [
    (['--validate', '--local-devices', '2'], {}, None),
    ([], dict(model=RECOGNIZER_CFG), 'trains'),
    ([], dict(model=dict(type='TEM')), 'localizer'),
], ids=['local_devices', 'recognizer', 'localizer'])
def test_later_slices_train_through_the_cli(data, tmp_path, argv, extra,
                                            item):
    """The train CLI on what later slices ported. A localizer config,
    refused before slice 13 ported localization (ROADMAP Queue 1 item
    7b), trains (``item`` 'localizer': TEM, two epochs of 2 steps on 4
    videos, a checkpoint an epoch). A recognizer config, refused before
    slice 12 ported recognition (item 7a), trains (``item`` 'trains':
    two epochs of 2 steps on the fixture's 4 clips).
    Item 5's ``--validate --local-devices 2``, refused before slice 8
    ported it, now trains and validates over two CPU workers (``item``
    None) with the J&F of the one-device validation."""
    if item == 'trains':
        extra = dict(extra, data=_recognizer_data(data))
    if item == 'localizer':
        extra = _localizer_extra(tmp_path)
    config = _write_config(data, tmp_path, **extra)
    args = [config, '--work-dir', str(tmp_path / 'w'), '--device', 'cpu',
            *argv]
    if item in ('trains', 'localizer'):
        state = tools_train.main(args)
        assert state.step == 4
        if item == 'localizer':
            assert sorted(os.listdir(tmp_path / 'w' / 'checkpoints')) == [
                'epoch_1', 'epoch_2', 'latest']
        return
    state = tools_train.main(args)
    assert state.step == 4
    with open(tmp_path / 'w' / 'best.json') as f:
        best = json.load(f)
    args[2] = str(tmp_path / 'one')
    tools_train.main(args[:-2])
    with open(tmp_path / 'one' / 'best.json') as f:
        assert json.load(f) == best


def _trace_names(path):
    with open(path) as f:
        return {e.get('name', '') for e in json.load(f)['traceEvents']}


@pytest.mark.parametrize('steps', [2, 5], ids=['inside_run', 'past_run_end'])
def test_profile_traces_steps_from_two(data, tmp_path, steps):
    """``--profile N`` traces steps [2, 2+N) into ``work_dir/profile``; a
    run with fewer steps closes the trace at its end. The trace names the
    step's operators (the backbone's convolutions and the update)."""
    config = _write_config(data, tmp_path)
    work = tmp_path / 'w'
    state = tools_train.main([config, '--work-dir', str(work), '--device',
                              'cpu', '--profile', str(steps)])
    assert state.step == 4
    names = _trace_names(work / 'profile' / 'trace_rank0.json')
    assert 'aten::convolution' in names or 'aten::conv2d' in names
    assert sum(n.startswith('aten::') for n in names) > 20


def test_profile_trace_holds_the_program_spans(data, tmp_path):
    """Under ``--profile N`` the program's spans (``utils.trace``) of the
    profiled steps are in the written trace, beside the operators."""
    config = _write_config(data, tmp_path)
    work = tmp_path / 'w'
    tools_train.main([config, '--work-dir', str(work), '--device', 'cpu',
                      '--profile', '1'])
    names = _trace_names(work / 'profile' / 'trace_rank0.json')
    assert {'train.step', 'train.h2d', 'train.forward', 'train.backward',
            'train.optimizer'} <= names
    assert 'aten::convolution' in names or 'aten::conv2d' in names


def test_log_entries_carry_the_loader_wait(data, tmp_path):
    """Each train log entry carries ``data_time``, the mean wait for the
    loader an iteration, which is part of ``time``."""
    config = _write_config(data, tmp_path)
    work = tmp_path / 'w'
    tools_train.main([config, '--work-dir', str(work), '--device', 'cpu'])
    lines = [json.loads(ln) for ln in
             (work / 'train_log.jsonl').read_text().split('\n') if ln]
    train = [r for r in lines if r['mode'] == 'train']
    assert len(train) == 4
    for r in train:
        assert 0.0 < r['data_time'] <= r['time']


def test_profiler_that_fails_to_start_raises(data, tmp_path, monkeypatch):
    import torch.profiler

    def refuse(self):
        raise RuntimeError('profiler refused')
    monkeypatch.setattr(torch.profiler.profile, 'start', refuse)
    config = _write_config(data, tmp_path)
    with pytest.raises(RuntimeError, match='profiler refused'):
        tools_train.main([config, '--work-dir', str(tmp_path / 'w'),
                          '--device', 'cpu', '--profile', '1'])


def test_deviceaug_pipeline_trains_through_the_cli(data, tmp_path):
    """``cfg.device_aug`` with the ``DeviceAug`` host pipeline through
    ``python -m vfs_tpu_torch.tools.train --device cpu``: the loader ships
    uint8 staging clips and the chain crops them to 32x32 in the step."""
    pipeline = [dict(type='OpenCVInit'),
                dict(type='SampleFrames', clip_len=1, frame_interval=0,
                     num_clips=4, out_of_bound_opt='loop'),
                dict(type='Clip2Frame', clip_len=2),
                dict(type='OpenCVDecode'),
                dict(type='DeviceAug', scale=(40, 30)),
                dict(type='Collect', keys=['imgs', 'label', 'orig_hw'],
                     meta_keys=())]
    cfg = _cfg_dict(data, tmp_path)
    cfg['data']['train']['dataset']['pipeline'] = pipeline
    config = _write_config(data, tmp_path, data=cfg['data'], device_aug=dict(
        out_hw=(32, 32), transforms=[
            dict(type='RandomResizedCrop', area_range=(0.2, 1.0),
                 same_across_clip=False, same_on_clip=False),
            dict(type='Flip', flip_ratio=0.5, same_across_clip=False,
                 same_on_clip=False),
            dict(type='RandomGrayScale', p=0.2, same_across_clip=False,
                 same_on_clip=False)]),
        img_norm_cfg=dict(mean=[123.675, 116.28, 103.53],
                          std=[58.395, 57.12, 57.375], to_bgr=False))
    work = tmp_path / 'w'
    state = tools_train.main([config, '--work-dir', str(work), '--device',
                              'cpu'])
    assert state.step == 4
    assert 'on-device augmentation enabled' in (work / 'train.log').read_text()
    lines = [json.loads(ln) for ln in
             (work / 'train_log.jsonl').read_text().split('\n') if ln]
    assert all(np.isfinite(r['loss']) for r in lines if r['mode'] == 'train')


class FakeWandb:
    """A stand-in ``wandb`` module that records its calls."""

    def __init__(self):
        self.calls = []

    def init(self, **kwargs):
        self.calls.append(('init', kwargs))
        fake = self

        class Run:
            def finish(self):
                fake.calls.append(('finish',))
        return Run()

    def log(self, payload, step=None):
        self.calls.append(('log', payload, step))


def test_wandb_loggers_make_jax_calls(monkeypatch, caplog):
    """Both packages' loggers send a fake ``wandb`` the same init, log and
    finish calls; without the package both warn and log nothing."""
    from vfs_tpu.utils import build_wandb_logger as jax_build_wandb_logger
    from vfs_tpu_torch.utils import build_wandb_logger
    hook = dict(type='WandbLoggerHook', init_kwargs=dict(project='vfs',
                                                         dir='w'))
    entries = [(dict(mode='train', epoch=1, iter=2, lr=0.05, loss=1.5), 2),
               (dict(mode='val', epoch=1, **{'J&F-Mean': 0.5}), 4)]
    calls = []
    for build in (jax_build_wandb_logger, build_wandb_logger):
        fake = FakeWandb()
        monkeypatch.setitem(sys.modules, 'wandb', fake)
        logger = build(dict(interval=1, hooks=[hook]))
        assert logger.active
        for entry, step in entries:
            logger.log(entry, step=step)
        logger.finish()
        logger.finish()
        calls.append(fake.calls)
    assert calls[0] == calls[1]
    assert [c[0] for c in calls[1]] == ['init', 'log', 'log', 'finish']
    assert build_wandb_logger(dict(interval=1)) is None
    assert build_wandb_logger(None) is None
    monkeypatch.setitem(sys.modules, 'wandb', None)  # not installed
    for build in (jax_build_wandb_logger, build_wandb_logger):
        logger = build(dict(hooks=[hook]))
        assert not logger.active
        logger.log(entries[0][0], step=1)
        logger.finish()


def test_wandb_hook_logs_train_and_val_entries(data, tmp_path, monkeypatch):
    """With a ``WandbLoggerHook``, train entries go to wandb at the log
    interval and val entries after each eval, at the update count, then
    ``finish``; ``--suffix`` moves the wandb dir."""
    fake = FakeWandb()
    monkeypatch.setitem(sys.modules, 'wandb', fake)
    config = _write_config(data, tmp_path, log_config=dict(interval=1, hooks=[
        dict(type='WandbLoggerHook', init_kwargs=dict(project='p',
                                                      dir='wdir'))]))
    state = tools_train.main([config, '--work-dir', str(tmp_path / 'w'),
                              '--device', 'cpu', '--validate', '--suffix',
                              's'])
    assert state.step == 4
    assert fake.calls[0] == ('init', dict(project='p', dir='wdir-s'))
    assert fake.calls[-1] == ('finish',)
    logs = fake.calls[1:-1]
    modes = [('J&F-Mean' in c[1], c[2]) for c in logs]
    assert modes == [(False, 1), (False, 2), (True, 2), (False, 3),
                     (False, 4), (True, 4)]
    assert all(isinstance(v, (int, float)) for c in logs
               for v in c[1].values())


def test_tools_train_under_torchrun_env_on_two_processes(data, tmp_path):
    """``--launcher pytorch`` reads torchrun's environment: two gloo
    processes, each on its shard (8 samples, 2 a step, 2 steps), rank 0
    writing the checkpoint and the log. Joined with a timeout of their own,
    so a hang fails the test."""
    config = _write_config(data, tmp_path, total_epochs=1, data=dict(
        _cfg_dict(data, tmp_path)['data'], videos_per_gpu=2))
    work = str(tmp_path / 'ddp')
    with socket.socket() as sock:
        sock.bind(('localhost', 0))
        port = sock.getsockname()[1]
    procs = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                   WORLD_SIZE='2', MASTER_ADDR='localhost',
                   MASTER_PORT=str(port), OMP_NUM_THREADS='1',
                   PYTHONPATH=ROOT)
        procs.append(subprocess.Popen(
            [sys.executable, '-m', 'vfs_tpu_torch.tools.train', config,
             '--work-dir', work, '--device', 'cpu', '--launcher',
             'pytorch'], env=env, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    saved = torch.load(osp.join(work, 'checkpoints', 'epoch_1'),
                       weights_only=True)
    assert saved['step'] == 2
    lines = [json.loads(ln) for ln in
             open(osp.join(work, 'train_log.jsonl')).read().split('\n')
             if ln]
    assert [r['iter'] for r in lines if r['mode'] == 'train'] == [1, 2]


def test_disable_wandb_drops_the_hook(data, tmp_path):
    config = _write_config(data, tmp_path, total_epochs=1, log_config=dict(
        interval=1, hooks=[dict(type='WandbLoggerHook')]))
    state = tools_train.main([config, '--work-dir', str(tmp_path / 'w'),
                              '--device', 'cpu', '--disable-wandb'])
    assert state.step == 2


def test_eval_hook_rule_and_best_json(tmp_path):
    scores = iter([0.5, 0.4, 0.7])
    hook = EvalHook(lambda: {'J&F-Mean': next(scores)}, interval=1,
                    key_indicator='J&F-Mean', work_dir=str(tmp_path))
    assert hook.rule == 'greater'
    for epoch in range(3):
        hook.after_epoch(epoch)
        best = json.loads((tmp_path / 'best.json').read_text())
        assert best['best_score'] == [0.5, 0.5, 0.7][epoch]
        assert best['best_epoch'] == [1, 1, 3][epoch]
    assert EvalHook(lambda: {}, key_indicator='val_loss').rule == 'less'
    assert EvalHook(lambda: {}, interval=2).after_epoch(0) is None
    with pytest.raises(ValueError, match='rule'):
        EvalHook(lambda: {}, key_indicator='something')
    log = JsonlLogger(str(tmp_path / 'sub' / 'log.jsonl'))
    log.log(dict(a=np.float32(1.5), b=np.int64(2), c=np.arange(2)))
    rec = json.loads((tmp_path / 'sub' / 'log.jsonl').read_text())
    assert (rec['a'], rec['b'], rec['c']) == (1.5, 2, [0, 1])
    assert 'time' in rec
