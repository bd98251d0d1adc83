"""One run of one cell: the card check, the cell's driver (set-up, the
measured window, the comparison that decides ``correct``), the per-layer
readers of a traced run, the check for JAX, and the result line.

The driver is a module ``drivers/<name>.py`` with ``run(ctx) -> Outcome``
(the configuration names it). Whatever a reader needs beyond the trace
goes into ``Outcome.counts``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Callable, Dict, List, NamedTuple, Optional

from . import card, spec

# top-level module names that no run may load
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'vfs_tpu')


class Check(NamedTuple):
    """One number compared, with its limit: ``correct`` needs
    ``value <= limit``."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


class Context(NamedTuple):
    cell: spec.Cell
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float
    peaks: Optional[card.Peaks]
    tamper: Optional[Callable] = None   # tests: break the timed path


class Outcome(NamedTuple):
    setup_s: float
    end_to_end: Dict[str, float]
    attempted: int
    failed: int
    memory_peak_bytes: int
    checks: List[Check]
    counts: Dict
    trace: object = None        # trace.Trace of a traced run
    extra: Dict = {}            # printed beside the result, not read


class MetricContext(NamedTuple):
    """What a per-layer reader gets."""
    trace: object
    counts: Dict
    peaks: Optional[card.Peaks]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Run one benchmark cell once')
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    return sorted({m.split('.')[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def per_layer(cell: spec.Cell, outcome: Outcome, peaks, bench_dir: str
              ) -> Dict[str, Dict]:
    ctx = MetricContext(outcome.trace, outcome.counts, peaks)
    out = {}
    for m in cell.per_layer:
        value = spec.metric_reader(m['name'], bench_dir).read(ctx)
        if value is not None:
            out[m['name']] = dict(value=float(value), unit=m['unit'])
    return out


def result_line(cell: spec.Cell, outcome: Outcome, device: Dict,
                traced: bool, peaks, bench_dir: str, card_info: Dict
                ) -> Dict:
    """The result line; the compared numbers come last."""
    if traced:
        metrics = per_layer(cell, outcome, peaks, bench_dir)
    else:
        values = dict(outcome.end_to_end, setup_s=outcome.setup_s)
        metrics = {m['name']: dict(value=float(values[m['name']]),
                                   unit=m['unit'])
                   for m in cell.end_to_end}
    line = dict(correct=all(c.ok for c in outcome.checks) and
                bool(outcome.checks),
                attempted=outcome.attempted, failed=outcome.failed,
                metrics=metrics, device=device)
    if traced and outcome.trace is not None:
        from .trace import breakdown
        line['breakdown'] = breakdown(outcome.trace)
    line.update(outcome.extra)
    line['card'] = card_info
    line['checks'] = {c.name: dict(value=c.value, limit=c.limit)
                      for c in outcome.checks}
    return line


def run(argv=None, t_start: float = None, device: str = None,
        bench_dir: str = spec.BENCH_DIR, tamper: Callable = None,
        out=None) -> int:
    """Run the cell that ``argv`` names and print its result line on
    ``out`` (stdout). ``device`` None measures the card and requires one;
    tests pass ``'cpu'`` (and ``tamper``). Returns the exit code."""
    t_start = time.perf_counter() if t_start is None else t_start
    out = sys.stdout if out is None else out
    args = parse_args(argv)
    path = spec.bench_file(bench_dir)
    if path is None:
        print('BENCHMARK.json not found', file=sys.stderr)
        return 2
    cell = spec.find_cell(spec.load_json(path), args.workload, bench_dir)
    import torch
    if device is None:
        try:
            card.require_cards(cell.chips)
            name = torch.cuda.get_device_name(0)
            peaks = card.peaks(name)
        except (RuntimeError, card.UnknownCard) as e:
            print(f'portbench: {e}', file=sys.stderr)
            return 2
        device, limit = 'cuda', card.power_limit()
        dev_info = dict(platform='gpu', kind=name, count=cell.chips)
    else:
        peaks, limit = None, 'not read'
        dev_info = dict(platform='cpu', kind='cpu', count=1)
    ctx = Context(cell, args.seed, args.seconds, bool(args.trace), device,
                  t_start, peaks, tamper)
    outcome = spec.driver(cell.config, bench_dir).run(ctx)
    dev_info['memory_peak_bytes'] = outcome.memory_peak_bytes
    if args.trace and outcome.trace is not None:
        dev_info['busy_s'] = outcome.trace.busy_s
        dev_info['window_s'] = outcome.trace.window_s
    bad = forbidden_modules()
    if bad:
        print(f'portbench: the run loaded {bad}', file=sys.stderr)
        return 3
    line = result_line(cell, outcome, dev_info, bool(args.trace), peaks,
                       bench_dir, dict(name=dev_info['kind'],
                                       power_limit=limit,
                                       peak_row=peaks.row if peaks else None))
    for c in outcome.checks:
        print(f'check {c.name} value {c.value!r} limit {c.limit!r} '
              f'{"ok" if c.ok else "FAILED"}', file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), file=out, flush=True)
    return 0
