"""The recognizer train cell ``train_slowfast_r50`` at a tiny size on the
CPU (base channels 16 / 2, 16 frames of 32x32, 2 clips, ten classes, the
clip engaged at max norm 1): the driver's run is ``correct``, a broken
timed path is not; the frozen Conv3d count gives the paper's figure; the
new readers give None where the program recorded no span or counter.

Run: ``python -m pytest portbench/tests/test_slowfast_cell.py -q``.
"""

import json
import os

import pytest
import torch

from conftest import make_tiny_copy
from helpers import run_cell
from portbench.drivers import recognizer_step
from portbench.harness import card, conv_work, program_trace, spec
from portbench.harness.runner import MetricContext
from portbench.reference import slowfast
from test_spec import bench

CELL = 'tiny_slowfast'
NEW_READERS = ('slowfast.slow_ms_per_step', 'slowfast.fast_ms_per_step',
               'slowfast.lateral_ms_per_step', 'slowfast.fast_roofline',
               'slowfast.lateral_roofline', 'train.clip_ms_per_step')


def _load(path):
    with open(path) as f:
        return json.load(f)


def _write(path, obj):
    with open(path, 'w') as f:
        json.dump(obj, f, indent=1)


@pytest.fixture(scope='module')
def slowfast_bench(tmp_path_factory):
    """A copy of the benchmark with the tiny SlowFast cell added as new
    files and entries beside ``train_slowfast_r50``'s."""
    dest = str(tmp_path_factory.mktemp('slowfast_bench'))
    bench_dir = make_tiny_copy(dest)
    configs = os.path.join(bench_dir, 'configs')
    traffic = os.path.join(bench_dir, 'traffic')
    c = _load(os.path.join(configs, 'slowfast_r50_4x16.json'))
    bb = c['model']['backbone']
    bb['slow_pathway']['base_channels'] = 16
    bb['fast_pathway']['base_channels'] = 2
    c['model']['cls_head'].update(in_channels=16 * 32 + 2 * 32,
                                  num_classes=10)
    c['optimizer_config']['grad_clip']['max_norm'] = 1.0
    _write(os.path.join(configs, 'tiny_slowfast.json'), c)
    t = _load(os.path.join(traffic, 'k400_clips_32x224_on_device.json'))
    t.update(batch=2, frames=16, height=32, width=32, ring=3, trace_steps=2)
    _write(os.path.join(traffic, 'tiny_clips.json'), t)
    path = os.path.join(dest, 'BENCHMARK.json')
    b = _load(path)
    b['configs'].append(dict(
        name='tiny_slowfast', source='https://arxiv.org/abs/1812.03982',
        file='portbench/configs/tiny_slowfast.json', reduced=[],
        why='SlowFast at base channels 16 / 2, for CPU tests'))
    b['workloads'].append(dict(name=CELL, config='tiny_slowfast',
                               traffic='tiny_clips', chips=1,
                               why='a CPU test size'))
    for m in b['end_to_end'] + b['per_layer']:
        if 'train_slowfast_r50' in m.get('workloads', ()):
            m['workloads'].append(CELL)
    _write(path, b)
    return bench_dir


def test_reference_agrees_with_the_program(slowfast_bench):
    rc, line = run_cell(slowfast_bench, CELL, seed=2**31 + 5, trace=1)
    assert rc == 0 and line['correct'], line
    assert line['failed'] == 0


def test_clip_engaged_and_readings_within_limits(slowfast_bench):
    b = spec.load_json(spec.bench_file(slowfast_bench))
    c = spec.find_cell(b, CELL, slowfast_bench)
    state = recognizer_step.seeded_state(c.config, 23, 'cpu')
    ref = recognizer_step.reference_steps(c.config, c.traffic, 23, 'cpu',
                                          state)
    total = [sum(v * v for v in g.values()) ** 0.5 for g in ref['step_grads']]
    assert all(abs(t - 1.0) < 1e-4 for t in total), total
    checks, _ = recognizer_step.readings(c, 23, 'cpu', 'program')
    assert all(x.ok for x in checks), checks


@pytest.mark.parametrize('fault', ('no_laterals', 'half_batch'))
def test_fault_is_not_correct(slowfast_bench, fault):
    rc, line = run_cell(slowfast_bench, CELL,
                        tamper=recognizer_step.FAULTS[fault])
    assert rc == 0 and line['correct'] is False, line['checks']


@pytest.mark.parametrize('hw,gmac', ((224, 27.64), (256, 36.1)))
def test_conv3d_count_of_a_clip(hw, gmac):
    """27.64 GMAC a 32-frame clip at 224x224; the paper's 36.1 GFLOPs
    (multiply-accumulates) at 256x256."""
    cfg = spec.find_cell(bench(), 'train_slowfast_r50').config
    with torch.device('meta'):
        model = slowfast.SlowFast(cfg['model'])
    work = conv_work.slowfast_work(model, (32, hw, hw, 3), 1)
    assert round(work['macs_per_clip'] / 1e9, 2 if hw == 224 else 1) == gmac


def test_step_count_by_layer():
    """x3 a layer, x2 the stems; the parts' FLOPs are their layers'."""
    cfg = spec.find_cell(bench(), 'train_slowfast_r50').config
    with torch.device('meta'):
        model = slowfast.SlowFast(cfg['model'])
    work = conv_work.layer_work(model, lambda m: m(torch.zeros(
        1, 1, 32, 224, 224, 3, device='meta')))
    stems = work['backbone.slow_path.conv1.conv'].macs \
        + work['backbone.fast_path.conv1.conv'].macs
    total = sum(w.macs for w in work.values())
    with torch.device('meta'):
        model = slowfast.SlowFast(cfg['model'])
    counted = conv_work.slowfast_work(model, (32, 224, 224, 3), 4)
    assert counted['step_flops'] == pytest.approx(2 * 4 * (3 * total
                                                           - stems))
    lat = sum(w.macs for k, w in work.items() if 'lateral' in k)
    assert counted['lateral']['flops'] == pytest.approx(2 * 4 * lat)
    assert len([k for k in work if 'lateral' in k]) == 4


@pytest.mark.parametrize('name', NEW_READERS)
def test_new_readers_give_none_without_their_spans(name):
    """A program that records other spans (the train step's) gives none."""
    reader = spec.metric_reader(name)
    peaks = card.peaks('NVIDIA H100 80GB HBM3')
    work = dict(fast=dict(flops=1e9, bytes=1e9),
                lateral=dict(flops=1e9, bytes=1e9))
    other = program_trace.ProgramTrace([], {}, {'train.step': dict(
        device_s=1.0)})
    for counts in ({}, dict(traced_steps=6, program=None,
                            slowfast_work=work),
                   dict(traced_steps=6, program=other, slowfast_work=work)):
        assert reader.read(MetricContext(None, counts, peaks)) is None


@pytest.mark.parametrize('name', NEW_READERS)
def test_new_readers_read_their_spans(name):
    span = {'slowfast.slow_ms_per_step': 'slowfast.slow',
            'slowfast.fast_ms_per_step': 'slowfast.fast',
            'slowfast.lateral_ms_per_step': 'slowfast.lateral',
            'slowfast.fast_roofline': 'slowfast.fast',
            'slowfast.lateral_roofline': 'slowfast.lateral',
            'train.clip_ms_per_step': 'optimizer.clip'}[name]
    peaks = card.Peaks(1e12, 1e12, 'test')
    program = program_trace.ProgramTrace(
        [], {'slowfast.concat_bytes': 2e9}, {span: dict(device_s=0.5)})
    counts = dict(traced_steps=5, program=program, slowfast_work=dict(
        fast=dict(flops=3e10, bytes=1e10),
        lateral=dict(flops=1e8, bytes=2e8)))
    value = spec.metric_reader(name).read(MetricContext(None, counts,
                                                        peaks))
    if name.endswith('_ms_per_step'):
        assert value == pytest.approx(100.0)      # 0.5 s over 5 steps
    elif name == 'slowfast.fast_roofline':
        assert value == pytest.approx(30.0)       # 5 x 30 ms of 500
    else:
        # 5 x 0.2 GB + 2 GB written over 1 TB/s: 3 ms of 500
        assert value == pytest.approx(0.6)
