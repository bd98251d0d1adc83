"""Fixtures of the benchmark's own tests: a copy of the benchmark with
tiny cells added as new files and entries (the way a later change adds
one), and the card check of the tests that need a CUDA device.

Run: ``python -m pytest portbench/tests -q`` from the repository root.
Tests marked ``card`` skip without a CUDA device; on the card they
read the controls at the cells' own sizes.
"""

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the tiny cells: (cell, config, traffic, the cell it stands in for)
TINY = (('tiny_davis', 'tiny_r50', 'tiny_davis', 'davis_r50_all_blocks'),
        ('tiny_train', 'vfs_r18', 'tiny_k400', 'pretrain_r18'),
        ('tiny_train_u8', 'vfs_r18', 'tiny_k400_u8',
         'pretrain_r18_deviceaug'))


def pytest_configure(config):
    config.addinivalue_line(
        'markers', 'card: needs a CUDA card (skips without one)')


def _write(path, obj):
    with open(path, 'w') as f:
        json.dump(obj, f, indent=1)


def _load(path):
    with open(path) as f:
        return json.load(f)


def make_tiny_copy(dest: str) -> str:
    """Copy ``BENCHMARK.json`` and ``portbench/`` under ``dest`` and add
    the tiny cells as new files and entries; returns the copy's
    benchmark folder."""
    shutil.copy(os.path.join(ROOT, 'BENCHMARK.json'), dest)
    shutil.copytree(os.path.join(ROOT, 'portbench'),
                    os.path.join(dest, 'portbench'),
                    ignore=shutil.ignore_patterns('__pycache__', 'tests'))
    bench_dir = os.path.join(dest, 'portbench')
    traffic = os.path.join(bench_dir, 'traffic')
    configs = os.path.join(bench_dir, 'configs')
    t = _load(os.path.join(traffic, 'davis17_val_480p_synth.json'))
    t.update(height=64, width=96, lengths=[5, 7])
    _write(os.path.join(traffic, 'tiny_davis.json'), t)
    c = _load(os.path.join(configs, 'vfs_r50_all_blocks.json'))
    for step in c['val_pipeline']:
        if step['type'] == 'Resize':
            step['scale'] = [-1, 64]
    # a 64x96 frame has 6,144 pixels: one label flipped at an object's edge
    # by a near tie is 1.6e-4 of it, where the card's limit is set at
    # 480x854
    c['limits'] = dict(c['limits'], mask_mismatch=1e-3)
    _write(os.path.join(configs, 'tiny_r50.json'), c)
    t = _load(os.path.join(traffic, 'k400_fp32_224_on_device.json'))
    t.update(batch=2, height=64, width=64, ring=4, trace_steps=2)
    _write(os.path.join(traffic, 'tiny_k400.json'), t)
    t = _load(os.path.join(traffic, 'k400_uint8_staging_on_device.json'))
    t.update(batch=2, height=64, width=80, ring=4, orig_hw=[64, 85],
             trace_steps=2)
    _write(os.path.join(traffic, 'tiny_k400_u8.json'), t)
    bench = _load(os.path.join(dest, 'BENCHMARK.json'))
    bench['configs'].append(dict(
        name='tiny_r50', source='https://arxiv.org/abs/2103.17263',
        file='portbench/configs/tiny_r50.json', reduced=[],
        why='the r50 all-blocks eval on 64x96 frames, for CPU tests'))
    for cell, config, traffic_name, like in TINY:
        bench['workloads'].append(dict(name=cell, config=config,
                                       traffic=traffic_name, chips=1,
                                       why='a CPU test size'))
        for m in bench['end_to_end'] + bench['per_layer']:
            if like in m.get('workloads', ()):
                m['workloads'].append(cell)
    _write(os.path.join(dest, 'BENCHMARK.json'), bench)
    return bench_dir


@pytest.fixture(scope='session')
def tiny_bench(tmp_path_factory):
    return make_tiny_copy(str(tmp_path_factory.mktemp('bench')))


@pytest.fixture
def card():
    """'cuda' where a CUDA device is present; skips the test elsewhere."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return 'cuda'
