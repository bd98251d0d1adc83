"""``train_model`` and ``python -m vfs_tpu_torch.tools.train`` on the CPU
(``device='cpu'`` / ``--device cpu``), mirroring
``tests/test_models/test_simsiam_train.py`` and
``tests/test_models/test_train_validate.py``: two epochs on
``make_video_dataset``'s videos, checkpoints, auto-resume, the DAVIS eval
hook on ``make_mini_davis`` with ``best.json``; the eval hand-off against
the JAX package's (same backbone weights, every metric within 1e-4); two
processes under torchrun's environment; the keys left for later slices;
the CLI's refusal to run without a GPU unless asked for the CPU.
"""

import json
import os
import os.path as osp
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


@pytest.mark.parametrize('argv,extra,item', [
    (['--profile', '2'], {}, 4),
    ([], dict(device_aug=dict(transforms=[])), 4),
    ([], dict(log_config=dict(interval=1, hooks=[
        dict(type='WandbLoggerHook')])), 4),
    (['--validate', '--local-devices', '2'], {}, 5),
    ([], dict(model=dict(type='Recognizer2D', backbone={})), 7),
], ids=['profile', 'device_aug', 'wandb', 'local_devices', 'recognizer'])
def test_later_slices_raise_naming_their_roadmap_item(data, tmp_path, argv,
                                                      extra, item):
    config = _write_config(data, tmp_path, **extra)
    with pytest.raises(NotImplementedError,
                       match=f'ROADMAP Queue 1 item {item}'):
        tools_train.main([config, '--work-dir', str(tmp_path / 'w'),
                          '--device', 'cpu', *argv])


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
