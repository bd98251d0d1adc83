"""Lookup by name: ``BENCHMARK.json``'s cells and metrics, and the files
that belong to one configuration, traffic mix, driver or per-layer
metric. A later cell, mix or metric is a new file beside these and a new
entry in ``BENCHMARK.json``; nothing here changes for it.

- ``configs/<config>.json``: the configuration as it is run; its
  ``driver`` key names ``drivers/<driver>.py``;
- ``traffic/<traffic>.json``: the parameters the general generator
  (``harness/traffic.py``) reads;
- ``metrics/<metric>.py``: a reader with ``read(ctx)`` that returns the
  metric's value or None where it finds nothing to read; the metric's
  entry lists the cells that read it under ``workloads``.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Dict, List, NamedTuple, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Cell(NamedTuple):
    """One workload of ``BENCHMARK.json`` with what it names."""
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: Dict
    traffic: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]


def load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """Import the file at ``path`` as a module called ``name`` (file names
    may hold dots, as metric names do)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f'cannot import {path}')
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def find_cell(bench: Dict, name: str, bench_dir: str = BENCH_DIR) -> Cell:
    """The cell ``name`` of the parsed ``BENCHMARK.json`` ``bench``, with
    its configuration and traffic read from ``bench_dir``. An unknown name
    raises ``KeyError``."""
    cells = {w['name']: w for w in bench['workloads']}
    if name not in cells:
        raise KeyError(f'no workload {name!r} in BENCHMARK.json '
                       f'(have {sorted(cells)})')
    w = cells[name]
    configs = {c['name']: c for c in bench['configs']}
    conf = configs[w['config']]
    root = os.path.dirname(bench_dir)
    config = load_json(os.path.join(root, conf['file']))
    traffic = load_json(os.path.join(bench_dir, 'traffic',
                                     w['traffic'] + '.json'))
    e2e = [m for m in bench['end_to_end']
           if name in m.get('workloads', [name])]
    per_layer = [m for m in bench['per_layer'] if name in m['workloads']]
    return Cell(name, w['config'], w['traffic'], int(w['chips']), config,
                traffic, e2e, per_layer)


def driver(config: Dict, bench_dir: str = BENCH_DIR):
    """The driver module that the configuration names."""
    name = config['driver']
    return load_module(os.path.join(bench_dir, 'drivers', name + '.py'),
                       f'portbench_driver_{name}')


def metric_reader(name: str, bench_dir: str = BENCH_DIR):
    """The reader module of per-layer metric ``name``."""
    return load_module(os.path.join(bench_dir, 'metrics', name + '.py'),
                       'portbench_metric_' + name.replace('.', '_'))


def bench_file(bench_dir: str = BENCH_DIR) -> Optional[str]:
    """``BENCHMARK.json`` beside the benchmark's folder."""
    path = os.path.join(os.path.dirname(bench_dir), 'BENCHMARK.json')
    return path if os.path.exists(path) else None
