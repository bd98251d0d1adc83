"""The analysis CLIs of vfs_tpu_torch (``vfs_tpu_torch.tools.analysis``)
with ``--device cpu`` at tiny sizes: the kernel and extraction benches,
the profiler trace, the FLOP and parameter counter (parameters equal to
the JAX package's count) and the log analysis. Their numbers here are
host times and say nothing of the card; the tests check what the CLIs
compute and print.
"""

import json
import os.path as osp
import sys

import jax
import numpy as np
import pytest
import torch

from vfs_tpu.models import build_backbone as jax_build_backbone
from vfs_tpu.utils import Config as JaxConfig
from vfs_tpu_torch.ops import local_topk_attend_cuda
from vfs_tpu_torch.tools.analysis import (analyze_logs, bench_extract,
                                          bench_kernel, get_flops,
                                          profile_kernel)
from vfs_tpu_torch.utils import JsonlLogger

torch.set_num_threads(1)

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
CONFIGS = {18: 'configs/r18_nc_sgd_cos_100e_r2_1xNx8_k400.py',
           50: 'configs/r50_nc_sgd_cos_100e_r5_1xNx2_k400.py'}
TINY_KERNEL = ['--device', 'cpu', '--frames', '4', '--hw', '10', '12',
               '--channels', '16', '--radius', '3', '--precede', '2',
               '--topk', '4', '--repeats', '1']
# the variants that select exactly (fp32 features and scores)
EXACT = ('pallas_fp32', 'tiled', 'pallas_wholefetch', 'pallas_batched',
         'video_fp32', 'video2_fp32_auto')


def test_bench_kernel_prints_every_variant(capsys):
    res = bench_kernel.main(TINY_KERNEL)
    out = capsys.readouterr().out
    names = list(bench_kernel.variants(bench_kernel.parse_args(
        TINY_KERNEL)))
    assert len(names) == 21 and not res['failed']
    assert set(res['ms_per_frame']) | set(res['same_as']) == set(names)
    for name in names:
        assert f'\n{name} ' in out or out.startswith(name)
    for name, same in res['same_as'].items():
        assert f'same_as {same}' in out
        assert same in res['ms_per_frame']
    # layout knobs are aliases: the tile, fetch, store and matmul of the
    # scan, the v1 engine's sweep rows and pass mode, the v2 engine's
    # query pairing and compaction
    assert res['same_as']['pallas_wholefetch'] == 'pallas_fp32'
    assert res['same_as']['video_bf16mm_rows4'] == 'video_bf16mm'
    assert res['same_as']['video2_bf16mm_q1'] == 'video2_bf16mm_auto'
    for name in EXACT:
        if name in res['agreement']:
            assert res['agreement'][name] == 1.0, name
    assert 'pallas_packed' in res['ms_per_frame']
    assert 'pallas_bf16' in res['ms_per_frame']
    assert local_topk_attend_cuda.launches == 0  # the CPU takes the plain


def test_bench_kernel_reports_a_failing_variant(monkeypatch, capsys):
    """A failing variant is printed and the exit code is 1; the tile
    sweep's variants are aliases of pallas_fp32."""
    variants = bench_kernel.variants

    def with_bad(args):
        out = variants(args)
        out['pallas_bad'] = out['pallas_fp32']._replace(
            pallas_extract='sweep')
        return out

    monkeypatch.setattr(bench_kernel, 'variants', with_bad)
    argv = TINY_KERNEL + ['--tiles', '8', '16']
    res = bench_kernel.main(argv)
    assert list(res['failed']) == ['pallas_bad']
    assert 'pallas_bad' in capsys.readouterr().out
    assert res['same_as'] == {'pallas_fp32_8x16': 'pallas_fp32'}
    assert bench_kernel.cli(argv) == 1
    monkeypatch.setattr(bench_kernel, 'variants', variants)
    assert bench_kernel.cli(argv) == 0


def test_profile_kernel_writes_a_trace(tmp_path, capsys):
    res = profile_kernel.main(['--device', 'cpu', '--frames', '3', '--hw',
                               '10', '12', '--repeats', '1', '--out',
                               str(tmp_path / 'trace')])
    assert osp.isfile(res['trace'])
    with open(res['trace']) as f:
        assert json.load(f)['traceEvents']
    assert res['kernels'] and res['kernel_ms'] > 0
    assert 'calls' in capsys.readouterr().out


def test_bench_extract_counts_flops(capsys):
    res = bench_extract.main(['--device', 'cpu', '--frames', '2', '--hw',
                              '32', '48', '--steps', '1', '2', '--repeats',
                              '1'])
    assert len(res['rows']) == 4  # two dtypes x two batch steps
    flops = {r['gflop_per_frame'] for r in res['rows']}
    assert len(flops) == 1 and flops.pop() > 0
    assert all(r['mfu'] is None for r in res['rows'])  # no device peak
    assert 'MFU not measured' in capsys.readouterr().out


def _jax_params(depth):
    """The JAX tool's parameter count (tools/analysis/get_flops.py)."""
    cfg = JaxConfig.fromfile(osp.join(ROOT, CONFIGS[depth]))
    backbone = jax_build_backbone(dict(cfg.model.backbone))
    variables = backbone.init(jax.random.PRNGKey(0),
                              np.zeros((1, 32, 32, 3), np.float32),
                              train=False)
    return sum(p.size for p in jax.tree.leaves(variables['params']))


@pytest.mark.parametrize('depth', [18, 50])
def test_get_flops_params_match_jax(depth, capsys):
    res = get_flops.main([osp.join(ROOT, CONFIGS[depth]), '--device', 'cpu',
                          '--shape', '32', '32'])
    assert res['params'] == _jax_params(depth)
    assert res['flops'] > 0
    assert f"Params: {res['params'] / 1e6:.2f} M" in capsys.readouterr().out


def test_analyze_logs(tmp_path, capsys):
    log = str(tmp_path / 'train_log.jsonl')
    logger = JsonlLogger(log)
    for i, t in enumerate((0.5, 0.25, 0.75)):
        logger.log(dict(mode='train', epoch=1, iter=i + 1, time=t,
                        loss=1.0 / (i + 1)))
    logger.log(dict(mode='val', epoch=1, **{'J&F-Mean': 0.5}))
    res = analyze_logs.main(['cal_train_time', log])[log]
    assert res == dict(mean=0.5, fastest=0.25, slowest=0.75, n=3)
    assert 'avg iter time 0.5000s' in capsys.readouterr().out
    out = analyze_logs.main(['plot_curve', log, '--keys', 'loss', '--out',
                             str(tmp_path / 'curve.png')])
    assert osp.getsize(out) > 0


def test_analyze_logs_plot_without_matplotlib_raises(tmp_path, monkeypatch):
    log = str(tmp_path / 'log.jsonl')
    JsonlLogger(log).log(dict(mode='train', time=1.0, loss=1.0))
    monkeypatch.setitem(sys.modules, 'matplotlib', None)
    with pytest.raises(RuntimeError, match='matplotlib'):
        analyze_logs.main(['plot_curve', log])


def _jax_bench_pretrain():
    sys.path.insert(0, ROOT)
    from tools.analysis import bench_pretrain as jax_tool
    return jax_tool


def test_bench_pretrain_defaults_equal_jax(monkeypatch):
    """Every option the JAX tool has defaults as it does there:
    ``--video-frames`` 100, ``--video-hw`` 256 340, ``--staging`` 256 320."""
    from vfs_tpu_torch.tools.analysis import bench_pretrain
    monkeypatch.setattr(sys, 'argv', ['bench_pretrain.py'])
    ref = vars(_jax_bench_pretrain().parse_args())
    ours = vars(bench_pretrain.parse_args([]))
    assert set(ref) <= set(ours)
    for key, value in ref.items():
        if key == 'config':
            assert osp.samefile(ours[key], value)
        else:
            assert tuple(np.atleast_1d(ours[key])) == \
                tuple(np.atleast_1d(value)), key
    assert ours['video_frames'] == 100 and ours['device_aug'] is False
    assert tuple(ours['staging']) == (256, 320)
    assert tuple(ours['video_hw']) == (256, 340)


@pytest.mark.parametrize('config', [
    'configs/r18_nc_sgd_cos_100e_r2_1xNx8_k400.py',
    'configs/r18_sgd_cos_100e_r2_1xNx8_k400.py',
    'configs/r18_sgd_cos_100e_r2_1xNx8_k400_deviceaug.py',
    'misordered',
])
def test_split_device_aug_pipeline_equals_jax(config):
    """The host/device split of a train pipeline equals the JAX tool's: the
    r18 host-aug configs (geometric only, and with the photometric
    chain), the ``_deviceaug`` config (already split: as it is, no device
    part), and a pipeline with a host-only step after device steps, which
    both refuse (tests/test_ops/test_device_aug.py:327-355)."""
    from vfs_tpu_torch.tools.analysis.bench_pretrain import \
        split_device_aug_pipeline
    jax_split = _jax_bench_pretrain().split_device_aug_pipeline
    if config == 'misordered':
        pipe = [dict(type='DecordInit'), dict(type='DecordDecode'),
                dict(type='Resize', scale=(-1, 256), keep_ratio=True),
                dict(type='RandomResizedCrop'),
                dict(type='Resize', scale=(224, 224), keep_ratio=False),
                dict(type='Flip', flip_ratio=0.5),
                dict(type='RandomErasing'),
                dict(type='Normalize', mean=[0] * 3, std=[1] * 3)]
        for split in (jax_split, split_device_aug_pipeline):
            with pytest.raises(ValueError, match='RandomErasing'):
                split(pipe, (256, 320))
        host, device = split_device_aug_pipeline(pipe[:6], (256, 320))
        assert [t['type'] for t in host] == [
            'DecordInit', 'DecordDecode', 'Resize', 'DeviceAug', 'Collect']
        assert host[2]['keep_ratio'] is True
        assert [t['type'] for t in device] == ['RandomResizedCrop', 'Resize',
                                               'Flip']
        return
    cfg = JaxConfig.fromfile(osp.join(ROOT, config))
    train = cfg.data['train']
    pipe = [dict(t) for t in train.get('dataset', train)['pipeline']]
    ours = split_device_aug_pipeline(pipe, (240, 300))
    ref = jax_split(pipe, (240, 300))
    assert ours == ref
    if 'deviceaug' in config:
        assert ours[1] is None and ours[0] == pipe
    else:
        assert ours[0][-2] == dict(type='DeviceAug', scale=(300, 240))
        assert [t['type'] for t in ours[1]][:3] == [
            'RandomResizedCrop', 'Resize', 'Flip']


def test_bench_pretrain_device_aug_on_the_cpu(tmp_path, capsys):
    """``--device-aug --device cpu``: the r18 train pipeline at a test size
    split at its crop, 24x32 staging frames cropped to 32x32 in the step,
    two steps; the three rates come out and the line names the clips'
    container."""
    from test_torch_train_data import NORM, train_pipeline
    from test_torch_train_step import MODEL_CFG, TRAIN_CFG
    from vfs_tpu_torch.tools.analysis import bench_pretrain
    from vfs_tpu_torch.tools.analysis.fixtures import clip_format, write_k400
    data = tmp_path / 'k400'
    data.mkdir()
    ann = write_k400(str(data), 2, 4, (48, 64))
    cfg = dict(model=MODEL_CFG, train_cfg=TRAIN_CFG, seed=0,
               img_norm_cfg=dict(NORM),
               data=dict(videos_per_gpu=2, workers_per_gpu=0,
                         train=dict(type='VideoDataset', ann_file=ann,
                                    data_prefix=str(data),
                                    pipeline=train_pipeline(
                                        'DecordInit', 'DecordDecode'))),
               optimizer=dict(type='SGD', lr=0.05, momentum=0.9,
                              weight_decay=1e-4),
               lr_config=dict(policy='CosineAnnealing', min_lr=0,
                              by_epoch=False))
    config = tmp_path / 'cfg.py'
    config.write_text(''.join(f'{k} = {v!r}\n' for k, v in cfg.items()))
    res = bench_pretrain.main([str(config), '--device', 'cpu', '--steps',
                               '2', '--data-dir', str(data), '--device-aug',
                               '--staging', '24', '32'])
    for key in ('loader_samples_per_s', 'device_steps_per_s',
                'e2e_steps_per_s'):
        assert res[key] > 0, key
    assert res['device_aug'] is True
    assert res['container'] == clip_format(str(tmp_path))[0] == 'mp4'
    out = capsys.readouterr().out
    assert 'device-aug: 3 transforms' in out and '(32, 32)' in out
    assert f'clips: mp4 in {data}' in out
