"""The benchmark finds every configuration, traffic mix, driver, metric
and cell by name, keeps to the contract's shapes, and takes a new cell
and metric as new files and entries alone."""

import json
import os
import re

import pytest

from conftest import ROOT
from helpers import run_cell
from portbench.harness import spec

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')


def bench():
    return spec.load_json(os.path.join(ROOT, 'BENCHMARK.json'))


def test_every_cell_resolves():
    b = bench()
    for w in b['workloads']:
        cell = spec.find_cell(b, w['name'])
        assert hasattr(spec.driver(cell.config), 'run')
        names = {m['name'] for m in cell.end_to_end}
        assert 'setup_s' in names and len(names) >= 2, w['name']
        assert cell.per_layer, w['name']
        for m in cell.per_layer:
            assert m['moves'] in names, (w['name'], m['name'])
            assert callable(spec.metric_reader(m['name']).read)


def test_contract_shapes():
    b = bench()
    assert set(b) == {'command', 'paths', 'run_seconds', 'configs',
                      'workloads', 'end_to_end', 'per_layer'}
    assert b['paths'] == ['portbench'] and 1 <= b['run_seconds'] <= 51
    seen = set()
    for c in b['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        assert c['file'].startswith('portbench/')
        assert os.path.exists(os.path.join(ROOT, c['file']))
    for w in b['workloads']:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
        assert w['chips'] == 1 and len(w['why']) <= 200
        assert (w['config'], w['traffic']) not in seen
        seen.add((w['config'], w['traffic']))
    for m in b['end_to_end']:
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= m['bound'] <= 0.25
    for m in b['end_to_end'] + b['per_layer']:
        assert NAME.match(m['name']) and UNIT.match(m['unit'])
        assert m['better'] in ('lower', 'higher')
    for m in b['per_layer']:
        assert set(m) == {'name', 'unit', 'better', 'source', 'layer',
                          'moves', 'workloads'}
        cells = {w['name'] for w in b['workloads']}
        assert set(m['workloads']) <= cells
    assert len(json.dumps(b)) < 64 * 1024


def test_unknown_cell_raises():
    with pytest.raises(KeyError):
        spec.find_cell(bench(), 'no_such_cell')


def test_added_cell_and_metric_run_without_an_edit(tiny_bench):
    """A new traffic file, a new metric reader and new entries, beside
    the tiny cells that the fixture added the same way: the cell runs and
    the new metric is read, with no file of the benchmark edited."""
    with open(os.path.join(tiny_bench, 'traffic', 'tiny_k400.json')) as f:
        t = json.load(f)
    t.update(ring=3)
    with open(os.path.join(tiny_bench, 'traffic', 'tiny_k400_b.json'),
              'w') as f:
        json.dump(t, f)
    with open(os.path.join(tiny_bench, 'metrics',
                           'train.test_steps.py'), 'w') as f:
        f.write('def read(ctx):\n'
                '    return ctx.counts.get("traced_steps")\n')
    path = os.path.join(os.path.dirname(tiny_bench), 'BENCHMARK.json')
    with open(path) as f:
        b = json.load(f)
    b['workloads'].append(dict(name='tiny_train_b', config='vfs_r18',
                               traffic='tiny_k400_b', chips=1, why='t'))
    b['end_to_end'][1]['workloads'].append('tiny_train_b')
    b['per_layer'].append(dict(name='train.test_steps', unit='steps',
                               better='higher', source='program_counter',
                               layer='dispatch', moves='train_samples_per_s',
                               workloads=['tiny_train_b']))
    with open(path, 'w') as f:
        json.dump(b, f)
    rc, line = run_cell(tiny_bench, 'tiny_train_b', trace=1)
    assert rc == 0 and line['correct'], line
    assert line['metrics']['train.test_steps']['value'] == 2
    rc, line = run_cell(tiny_bench, 'tiny_train_b', trace=0)
    assert rc == 0 and set(line['metrics']) == {'train_samples_per_s',
                                                'setup_s'}
    assert list(line)[-1] == 'checks'
