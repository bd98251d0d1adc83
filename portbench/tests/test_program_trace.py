"""The program's spans read against a traced window
(``harness/program_trace.py``) and the readers of the metrics they
give, on synthetic traces and on a CPU profile:

- ``trace.read`` and ``trace.breakdown`` give the same with and without
  the program's spans (in the events as the profiler's annotations, and
  read beside them);
- attribution: device time, kernels, blocking calls and their wait, idle
  gaps and self time, by ``trace.read``'s rules; the idle inside the
  outermost program spans plus the idle outside them is the window's;
- each new reader's value, and None where the run recorded no program
  spans (a program without them);
- a program span and a benchmark span around one call land within 50 us
  of each other, and of the profiler's own record of it, on the trace's
  clock.
"""

import json
import os
import tempfile
import threading

import pytest
import torch

from conftest import ROOT
from portbench.harness import program_trace, spec
from portbench.harness import trace as bench_trace
from portbench.harness.runner import MetricContext
from vfs_tpu_torch.utils import trace as program_api
from vfs_tpu_torch.utils.trace import Span

BASE_US = 1_000_000.0
TID = 1


class Rec:
    """A stand-in for ``utils.trace.Recording``."""

    def __init__(self, spans, counts=None):
        self.spans, self.counts = spans, counts or {}


def span(name, start, end, sid, parent=None, thread=TID, key=None):
    """A program span at ``start``..``end`` us on the trace's clock."""
    return Span(name, int((BASE_US + start) * 1e3),
                int((BASE_US + end) * 1e3), thread, parent, key, sid)


def runtime(name, ts, dur, corr=None):
    e = dict(cat='cuda_runtime', name=name, ts=ts, dur=dur)
    if corr is not None:
        e['args'] = dict(correlation=corr)
    return e


def kernel(name, ts, dur, corr):
    return dict(cat='kernel', name=name, ts=ts, dur=dur,
                args=dict(correlation=corr))


def train_case():
    """A 100 us window: one step (10..60) with a forward (12..30) and an
    update (40..55); kernel A launched in the forward, B in the update,
    C before the step; one synchronisation inside the step, one after;
    a decode span on another thread."""
    events = [runtime('cudaLaunchKernel', 5, 1, 3), kernel('C', 5, 3, 3),
              runtime('cudaLaunchKernel', 13, 1, 1), kernel('A', 20, 15, 1),
              runtime('cudaLaunchKernel', 41, 1, 2), kernel('B', 45, 5, 2),
              runtime('cudaStreamSynchronize', 56, 3),
              runtime('cudaDeviceSynchronize', 95, 2)]
    bench = [(bench_trace.WINDOW_SPAN, 0.0, 100.0, TID),
             ('portbench.step', 9.0, 61.0, TID)]
    rec = Rec([span('train.forward', 12, 30, 1, 0, key=1),
               span('train.optimizer', 40, 55, 2, 0, key=1),
               span('train.step', 10, 60, 0, key=1),
               span('test.decode', 0, 50, 3, thread=2)],
              {'tracker.blocks': 2})
    return events, bench, rec


def annotations(rec):
    """The program's spans as the profiler records ``record_function``."""
    return [dict(cat='user_annotation', name=s.name, ph='X',
                 ts=s.start_ns / 1e3 - BASE_US,
                 dur=(s.end_ns - s.start_ns) / 1e3) for s in rec.spans]


def test_read_and_breakdown_unchanged_by_program_spans():
    events, bench, rec = train_case()
    plain = bench_trace.read(events, bench)
    with_prog = events + annotations(rec)
    program_trace.read(with_prog, bench, rec, BASE_US)
    again = bench_trace.read(with_prog, bench)
    assert again == plain
    assert bench_trace.breakdown(again) == bench_trace.breakdown(plain)
    assert {o.span for o in plain.ops} == {'step', 'outside_spans'}


def test_attribution_by_the_rules_of_read():
    events, bench, rec = train_case()
    t = program_trace.read(events, bench, rec, BASE_US).table
    us = pytest.approx
    step, fwd, opt, out = (t['train.step'], t['train.forward'],
                           t['train.optimizer'], t['outside_spans'])
    assert step['count'] == 1 and step['host_s'] == us(50e-6)
    assert step['self_s'] == us(17e-6)          # 50 - 18 - 15
    assert step['device_s'] == us(20e-6) and step['self_device_s'] == 0
    assert step['kernels'] == 2
    assert step['blocking'] == step['self_blocking'] == 1
    assert step['wait_s'] == us(3e-6)
    assert fwd['device_s'] == us(15e-6) and fwd['idle_s'] == us(12e-6)
    assert opt['device_s'] == us(5e-6) and opt['idle_s'] == us(10e-6)
    assert step['idle_s'] == us(22e-6) and step['self_idle_s'] == 0
    assert out['device_s'] == us(3e-6) and out['blocking'] == 1
    assert out['idle_s'] == us(55e-6)
    assert t['test.decode']['host_s'] == us(50e-6)
    assert t['test.decode']['device_s'] == 0   # not the window's thread


def test_idle_inside_and_outside_sums_to_the_window():
    events, bench, rec = train_case()
    plain = bench_trace.read(events, bench)
    prog = program_trace.read(events, bench, rec, BASE_US)
    top = {s.name for s in prog.spans if s.parent is None
           and s.thread == TID}
    idle = sum(prog.table[n]['idle_s'] for n in top | {'outside_spans'})
    assert idle == pytest.approx(plain.window_s - plain.busy_s)
    assert idle == pytest.approx(sum(s for _, s in plain.gaps))
    self_idle = sum(r['self_idle_s'] for r in prog.table.values())
    assert self_idle == pytest.approx(idle)


def eval_case():
    """Two blocks of one video: labels (10..20) and readback (40..50) of
    each, with idle gaps inside them; a wait for input (0..5) and a
    decode on the prefetch thread with a preload inside it."""
    events = [runtime('cudaLaunchKernel', 21, 1, 1), kernel('row1', 22, 18, 1),
              runtime('cudaLaunchKernel', 71, 1, 2), kernel('row1', 72, 18, 2)]
    bench = [(bench_trace.WINDOW_SPAN, 0.0, 100.0, TID)]
    rec = Rec([span('test.wait_input', 0, 5, 0, key=0),
               span('tracker.labels', 10, 20, 1, 9, key=0),
               span('tracker.readback', 40, 50, 2, 9, key=0),
               span('tracker.labels', 60, 70, 3, 9, key=0),
               span('tracker.readback', 90, 99, 4, 9, key=0),
               span('test.video', 6, 100, 9, key=0),
               span('test.preload', 40, 50, 6, 5, thread=2),
               span('test.decode', 0, 50, 5, thread=2)],
              {'tracker.blocks': 2})
    return events, bench, rec


def reading(name, counts):
    ctx = MetricContext(None, counts, None)
    return spec.metric_reader(name).read(ctx)


def test_eval_readers():
    events, bench, rec = eval_case()
    prog = program_trace.read(events, bench, rec, BASE_US)
    counts = dict(frames=10, program=prog)
    assert reading('eval.input_wait_ms_per_frame', counts) == \
        pytest.approx(1e3 * 5e-6 / 10)
    assert reading('eval.host_decode_ms_per_frame', counts) == \
        pytest.approx(1e3 * 40e-6 / 10)
    # gaps: 0..22 (mid 11, labels), 40..72 (mid 56, video), 90..100
    # (mid 95, readback)
    assert reading('eval.between_blocks_idle_ms_per_block', counts) == \
        pytest.approx(1e3 * (22e-6 + 10e-6) / 2)


def test_train_readers():
    events, bench, rec = train_case()
    counts = dict(traced_steps=2,
                  program=program_trace.read(events, bench, rec, BASE_US))
    assert reading('train.host_issue_ms_per_step', counts) == \
        pytest.approx(1e3 * 47e-6 / 2)
    assert reading('train.host_wait_ms_per_step', counts) == \
        pytest.approx(1e3 * 3e-6 / 2)
    assert reading('train.optimizer_ms_per_step', counts) == \
        pytest.approx(1e3 * 5e-6 / 2)


@pytest.mark.parametrize('name', [
    'eval.input_wait_ms_per_frame', 'eval.host_decode_ms_per_frame',
    'eval.between_blocks_idle_ms_per_block', 'train.host_issue_ms_per_step',
    'train.host_wait_ms_per_step', 'train.optimizer_ms_per_step'])
def test_readers_find_nothing_without_program_spans(name):
    assert os.path.exists(os.path.join(ROOT, 'portbench', 'metrics',
                                       name + '.py'))
    assert reading(name, dict(frames=10, traced_steps=2)) is None


def test_program_and_benchmark_spans_meet_on_the_trace_clock():
    """One call inside a benchmark span and a program span, under a CPU
    profile: on the exported trace's clock they lie within 50 us of each
    other; recorded with ``annotate``, the program span holds the
    profiler's own record of it."""
    from torch.profiler import ProfilerActivity, profile
    spans = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        bench_trace._Spans.recorded = spans
        try:
            with program_api.recording() as rec:
                with bench_trace.span('extract'):
                    with program_api.span('tracker.extract'):
                        torch.ones(64, 64).sum()
        finally:
            bench_trace._Spans.recorded = None
        with program_api.recording(annotate=True) as annotated:
            for _ in range(2):
                with program_api.span('tracker.propagate'):
                    torch.ones(64, 64).sum()
    fd, path = tempfile.mkstemp(suffix='.json')
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            exported = json.load(f)
    finally:
        os.unlink(path)
    base_us = exported.get('baseTimeNanoseconds', 0) / 1e3
    (_, a, b, tid), = spans
    p, = program_trace.on_trace_clock(rec.spans, base_us)
    assert p.thread == tid == threading.get_ident()
    assert abs(p.start - (a - base_us)) < 50
    assert abs(p.end - (b - base_us)) < 50
    marks = [e for e in exported['traceEvents']
             if e.get('name') == 'tracker.propagate' and 'dur' in e]
    assert len(marks) == 2
    for p, e in zip(program_trace.on_trace_clock(annotated.spans, base_us),
                    sorted(marks, key=lambda e: e['ts'])):
        assert p.start - 1 <= e['ts'] <= e['ts'] + e['dur'] <= p.end + 1
