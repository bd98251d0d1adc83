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
