"""The analysis CLIs of vfs_tpu_torch that read data, with ``--device cpu``
(``bench_processing`` has no device) on the test fixtures at tiny sizes:
the eval loop's frames per second on the mini-DAVIS fixture, the host
pipeline on the train config's clips, the pretraining rates on
``fixtures.write_k400``'s clips, and SiamFC's five tracking modes on a
2-sequence OTB fixture, whose boxes must agree with ``host_seq``'s within
0.01 px. Their times here are host times, not device metrics.
"""

import os.path as osp

import numpy as np
import pytest
import torch

from vfs_tpu_torch.tools.analysis import (bench_pretrain, bench_processing,
                                          bench_track, benchmark)

from test_torch_tools_test import eval_setup  # noqa: F401  (fixture)
from test_torch_train_data import train_pipeline
from test_torch_train_step import MODEL_CFG, TRAIN_CFG

torch.set_num_threads(1)


def test_benchmark_on_mini_davis(eval_setup, capsys):  # noqa: F811
    config, ckpt, _ = eval_setup
    res = benchmark.main([config, ckpt, '--device', 'cpu', '--num-videos',
                          '1', '--options', 'test_cfg.topk=10'])
    assert res['videos'] == 1 and res['frames'] == 8 and res['fps'] > 0
    assert 'Overall:' in capsys.readouterr().out


@pytest.fixture(scope='module')
def train_config(tmp_path_factory):
    """A SimSiam config at a test size (32x32 crops, narrow heads) whose
    train set is two of ``write_k400``'s clips."""
    root = tmp_path_factory.mktemp('analysis_train')
    from vfs_tpu_torch.tools.analysis.fixtures import write_k400
    data = root / 'k400'
    data.mkdir()
    ann = write_k400(str(data), 2, 4, (48, 64))
    cfg = dict(model=MODEL_CFG, train_cfg=TRAIN_CFG, seed=0,
               data=dict(videos_per_gpu=2, workers_per_gpu=0,
                         train=dict(type='VideoDataset', ann_file=ann,
                                    data_prefix=str(data),
                                    pipeline=train_pipeline())),
               optimizer=dict(type='SGD', lr=0.05, momentum=0.9,
                              weight_decay=1e-4),
               lr_config=dict(policy='CosineAnnealing', min_lr=0,
                              by_epoch=False))
    path = root / 'cfg.py'
    path.write_text(''.join(f'{k} = {v!r}\n' for k, v in cfg.items()))
    return str(path), str(data), root


def test_bench_processing(train_config, capsys):
    config, _, _ = train_config
    res = bench_processing.main([config, '--num-samples', '3'])
    assert res['samples'] == 2 and res['samples_per_s'] > 0
    assert 'samples/s' in capsys.readouterr().out


def test_bench_pretrain(train_config, capsys):
    config, data, root = train_config
    res = bench_pretrain.main([config, '--device', 'cpu', '--steps', '2',
                               '--data-dir', data, '--profile',
                               str(root / 'prof')])
    for key in ('loader_samples_per_s', 'device_steps_per_s',
                'e2e_steps_per_s'):
        assert res[key] > 0, key
    assert 0.0 <= res['loader_blocked_share'] <= 1.0
    assert osp.isfile(res['trace'])
    out = capsys.readouterr().out
    assert 'loader-only' in out and 'end-to-end' in out


def test_bench_pretrain_refuses_device_aug_configs(tmp_path):
    """A config whose augmentations run on the device (the _deviceaug
    config) needs ``--device-aug``: without it the tool raises once the
    clips are there, before any loader or step work."""
    config = osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))),
                      'configs',
                      'r18_sgd_cos_100e_r2_1xNx8_k400_deviceaug.py')
    with pytest.raises(ValueError, match='--device-aug'):
        bench_pretrain.main([config, '--device', 'cpu', '--num-videos', '1',
                             '--video-frames', '2', '--video-hw', '32', '48',
                             '--data-dir', str(tmp_path)])


def test_bench_track_modes_agree(tmp_path, capsys):
    res = bench_track.main(['--device', 'cpu', '--seqs', '2', '--frames',
                            '4', '--hw', '120', '160', '--batch', '2',
                            '--root', str(tmp_path / 'otb'), '--options',
                            'exemplar_sz=32', 'instance_sz=64'])
    modes = res['modes']
    assert list(modes) == list(bench_track.MODES)
    assert modes['host_seq']['box_vs_host_seq_px'] is None
    for mode in bench_track.MODES[1:]:
        assert modes[mode]['box_vs_host_seq_px'] <= 0.01, mode
        assert modes[mode]['fps'] > 0
    out = capsys.readouterr().out
    assert all(m in out for m in bench_track.MODES)
    assert np.isfinite([m['fps'] for m in modes.values()]).all()
