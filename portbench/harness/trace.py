"""The traced window: ``torch.profiler`` over the card, spans that the
benchmark places around calls into the program's layers (``span``), and
the reading of the exported trace.

The profiler records the card's activity alone (kernels, copies, memsets
and the runtime calls that launched them), not every host-side operator:
recording those costs the host microseconds an operator and would slow a
step that the host paces. The spans are kept by the benchmark itself on
the host's wall clock and placed on the trace's clock by its base time.

A device operation is tied to the runtime call that launched it (the
trace's correlation id), and through that call's host time to the
innermost span open on the window's thread. Idle time is the window less
the union of the device operations; each idle gap is put down to the span
the host was in halfway through it.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
import threading
import time
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

SPAN_PREFIX = 'portbench.'
WINDOW_SPAN = SPAN_PREFIX + 'window'
DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
RUNTIME_CATS = ('cuda_runtime', 'cuda_driver')


def blocks_host(call: str) -> bool:
    """Whether a runtime call waits for the card: a stream, event or
    device synchronisation (a copy to the host waits through one) or a
    synchronous copy."""
    return 'Synchronize' in call or call == 'cudaMemcpy'


class _Spans:
    """The spans of the traced window now open, or None outside one."""
    recorded = None


def span(name: str):
    """A named benchmark span around a call; kept only inside a traced
    window."""
    return _span(SPAN_PREFIX + name)


@contextlib.contextmanager
def _span(name: str):
    recorded = _Spans.recorded
    if recorded is None:
        yield
        return
    t0 = time.time_ns()
    try:
        yield
    finally:
        recorded.append((name, t0 / 1e3, time.time_ns() / 1e3,
                         threading.get_ident()))


def spanned(name: str, fn):
    """``fn`` wrapped in ``span(name)``."""
    def wrapped(*args, **kwargs):
        with span(name):
            return fn(*args, **kwargs)
    return wrapped


class DeviceOp(NamedTuple):
    name: str
    cat: str
    start: float        # us
    end: float          # us
    span: str           # the innermost benchmark span of its launch


class Trace(NamedTuple):
    ops: List[DeviceOp]
    window_s: float
    busy_s: float
    kernels: int
    blocking_calls: int             # inside the benchmark's spans
    gaps: List[Tuple[str, float]]   # (span, seconds), every gap


@contextlib.contextmanager
def traced(device, out: Dict):
    """Profile the card's activity over the block inside a window span;
    the card's queue is drained at both ends. ``out['trace']`` holds the
    read ``Trace`` afterwards (on the CPU, a trace with no device
    operations)."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.device(device).type == 'cuda'
    activities = [ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]
    if cuda:
        torch.cuda.synchronize()
    spans: List = []
    with profile(activities=activities) as prof:
        _Spans.recorded = spans
        try:
            with _span(WINDOW_SPAN):
                yield
                if cuda:
                    torch.cuda.synchronize()
        finally:
            _Spans.recorded = None
    fd, path = tempfile.mkstemp(suffix='.json')
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            exported = json.load(f)
    finally:
        os.unlink(path)
    base_us = exported.get('baseTimeNanoseconds', 0) / 1e3
    out['trace'] = read(exported['traceEvents'],
                        [(n, a - base_us, b - base_us, tid)
                         for n, a, b, tid in spans])


def _union(intervals: List[Tuple[float, float]]):
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def read(events: List[Dict], spans: List[Tuple]) -> Trace:
    """The ``Trace`` of a chrome trace's events and the benchmark's spans
    ((name, start us, end us, thread) on the trace's clock)."""
    window = [s for s in spans if s[0] == WINDOW_SPAN]
    if not window:
        raise ValueError('no window span')
    _, w0, w1, tid = window[0]
    inner = sorted(((a, b, n[len(SPAN_PREFIX):]) for n, a, b, t in spans
                    if t == tid and n != WINDOW_SPAN), key=lambda s: s[0])
    starts = [s[0] for s in inner]

    def span_at(ts: float) -> str:
        """The innermost span open at host time ``ts``."""
        best = 'outside_spans'
        for s0, s1, name in inner[:bisect.bisect_right(starts, ts)]:
            if s0 <= ts < s1:
                best = name   # later starts are nested deeper
        return best

    launch = {}
    blocking = 0
    for e in events:
        if e.get('cat') in RUNTIME_CATS:
            corr = (e.get('args') or {}).get('correlation')
            if corr is not None:
                launch[corr] = e['ts']
            if w0 <= e['ts'] <= w1 and blocks_host(e['name']) \
                    and span_at(e['ts']) != 'outside_spans':
                blocking += 1
    ops = []
    for e in events:
        if e.get('cat') not in DEVICE_CATS or 'dur' not in e:
            continue
        s, end = e['ts'], e['ts'] + e['dur']
        if end < w0 or s > w1:
            continue
        corr = (e.get('args') or {}).get('correlation')
        host = launch.get(corr)
        ops.append(DeviceOp(e['name'], e['cat'], max(s, w0), min(end, w1),
                            span_at(host) if host is not None
                            else 'outside_spans'))
    merged = _union([(o.start, o.end) for o in ops])
    busy = sum(e - s for s, e in merged)
    gaps = []
    at = w0
    for s, e in merged + [[w1, w1]]:
        if s > at:
            gaps.append((span_at((at + s) / 2), (s - at) / 1e6))
        at = max(at, e)
    return Trace(ops, (w1 - w0) / 1e6, busy / 1e6,
                 sum(1 for o in ops if o.cat == 'kernel'), blocking, gaps)


def device_seconds(trace: Trace, keys=None, span_name: str = None) -> float:
    """Seconds of device operations whose name holds one of ``keys``
    (lower case; all where None) and, where ``span_name`` is given, that
    were launched inside that span."""
    total = 0.0
    for o in trace.ops:
        if span_name is not None and o.span != span_name:
            continue
        if keys is not None and not any(k in o.name.lower() for k in keys):
            continue
        total += (o.end - o.start) / 1e6
    return total


def breakdown(trace: Trace, n: int = 10) -> Dict:
    """The ``n`` device operations that took the most time, by name, and
    the idle time by the host span it fell in."""
    by_op: Dict[str, float] = defaultdict(float)
    for o in trace.ops:
        by_op[o.name[:96]] += (o.end - o.start) / 1e6
    by_gap: Dict[str, float] = defaultdict(float)
    for name, seconds in trace.gaps:
        by_gap[name] += seconds
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:n]
    gaps = sorted(by_gap.items(), key=lambda kv: -kv[1])[:n]
    return dict(device_ops=[[k, v] for k, v in top],
                idle_gaps=[[k, v] for k, v in gaps])


def idle_share(trace: Trace) -> Optional[float]:
    if trace.window_s <= 0:
        return None
    return 1.0 - trace.busy_s / trace.window_s
