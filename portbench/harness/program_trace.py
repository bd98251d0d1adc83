"""The program's own spans and counters (``vfs_tpu_torch.utils.trace``)
read against a traced window, kept apart from the benchmark's spans:
``trace.read``, ``trace.breakdown`` and their readers never see them.

``read`` takes the exported profiler trace's events, the benchmark's
spans (for the window span), a ``Recording`` of the program made over the
same window and the trace's base time, and attributes by the rules
``trace.read`` uses, to the innermost program span open on the window's
thread: a device operation by the host time of the runtime call that
launched it, an idle gap by its midpoint, a blocking runtime call by its
start. A span's ``self_s`` is its duration less the time its child spans
cover.

Each row of ``ProgramTrace.table`` (one a span name, and
``outside_spans`` for what falls in no program span) gives: ``count``,
``host_s``, ``self_s``; ``device_s``, ``ops`` and ``kernels`` launched
inside a span of that name (its children included; ``self_device_s``
without them); ``blocking`` calls inside it (``self_blocking``) and
``wait_s``, the host's time in them; ``idle_s`` (``self_idle_s``), the
card's idle time whose gap falls inside it.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional, Tuple

from .trace import (DEVICE_CATS, RUNTIME_CATS, WINDOW_SPAN, _union,
                    blocks_host)

OUTSIDE = 'outside_spans'
# the rows' fields, in the order the table prints them
FIELDS = ('count', 'host_s', 'self_s', 'device_s', 'self_device_s',
          'ops', 'kernels', 'blocking', 'self_blocking', 'wait_s', 'idle_s',
          'self_idle_s')


class ProgramSpan(NamedTuple):
    name: str
    start: float              # us, on the trace's clock
    end: float
    thread: int
    parent: Optional[int]
    key: object
    id: int


class ProgramTrace(NamedTuple):
    spans: List[ProgramSpan]
    counts: Dict[str, int]
    table: Dict[str, Dict[str, float]]


def on_trace_clock(spans, base_us: float) -> List[ProgramSpan]:
    """The program's spans (``utils.trace.Span``, ns on the wall clock)
    in microseconds on the trace's clock, whose zero is ``base_us``."""
    return [ProgramSpan(s.name, s.start_ns / 1e3 - base_us,
                        s.end_ns / 1e3 - base_us, s.thread, s.parent, s.key,
                        s.id) for s in spans]


def innermost(spans: List[ProgramSpan]):
    """A function of a host time (us) that gives the id of the innermost
    of ``spans`` (spans of one thread, nested) open at that time, by
    ``trace.read``'s rule (``start <= ts < end``; of several, the latest
    to start), or None."""
    marks: List[Tuple[float, int, int, int]] = []
    for s in spans:
        if s.end > s.start:
            marks.append((s.start, 1, s.id, s.id))
            marks.append((s.end, 0, -s.id, s.id))
    marks.sort()
    times: List[float] = []
    inner: List[Optional[int]] = []
    open_: List[int] = []
    for t, is_start, _, sid in marks:
        if is_start:
            open_.append(sid)
        else:
            open_.remove(sid)
        top = open_[-1] if open_ else None
        if times and times[-1] == t:
            inner[-1] = top
        else:
            times.append(t)
            inner.append(top)

    def at(ts: float) -> Optional[int]:
        i = bisect.bisect_right(times, ts) - 1
        return inner[i] if i >= 0 else None
    return at


def _self_seconds(spans: List[ProgramSpan]) -> Dict[int, float]:
    """Each span's duration less the union of its children's, in s."""
    children: Dict[int, List[Tuple[float, float]]] = defaultdict(list)
    for s in spans:
        if s.parent is not None:
            children[s.parent].append((s.start, s.end))
    out = {}
    for s in spans:
        covered = sum(min(e, s.end) - max(b, s.start) for b, e in
                      _union(children.get(s.id, [])) if e > b)
        out[s.id] = (s.end - s.start - covered) / 1e6
    return out


def read(events: List[Dict], spans: List[Tuple], recording,
         base_us: float) -> ProgramTrace:
    """The ``ProgramTrace`` of a chrome trace's ``events``, the
    benchmark's ``spans`` ((name, start us, end us, thread) on the
    trace's clock, the window span among them) and the program's
    ``recording`` (``utils.trace.Recording``) over the same window."""
    window = [s for s in spans if s[0] == WINDOW_SPAN]
    if not window:
        raise ValueError('no window span')
    _, w0, w1, tid = window[0]
    prog = on_trace_clock(recording.spans, base_us)
    by_id = {s.id: s for s in prog}
    at = innermost([s for s in prog if s.thread == tid])
    names_of: Dict[Optional[int], Tuple[str, ...]] = {None: (OUTSIDE,)}

    def names(sid: Optional[int]) -> Tuple[str, ...]:
        """The distinct names on the chain from ``sid`` up."""
        if sid not in names_of:
            chain, p = [], sid
            while p is not None:
                chain.append(by_id[p].name)
                p = by_id[p].parent
            names_of[sid] = tuple(dict.fromkeys(chain))
        return names_of[sid]

    rows: Dict[str, Dict[str, float]] = defaultdict(
        lambda: dict.fromkeys(FIELDS, 0))

    def add(sid: Optional[int], field: str, value: float) -> None:
        chain = names(sid)
        rows[chain[0]]['self_' + field] += value
        for name in chain:
            rows[name][field] += value

    launch = {}
    for e in events:
        if e.get('cat') not in RUNTIME_CATS:
            continue
        corr = (e.get('args') or {}).get('correlation')
        if corr is not None:
            launch[corr] = e['ts']
        if w0 <= e['ts'] <= w1 and blocks_host(e['name']):
            sid = at(e['ts'])
            add(sid, 'blocking', 1)
            for name in names(sid):
                rows[name]['wait_s'] += e.get('dur', 0) / 1e6
    intervals = []
    for e in events:
        if e.get('cat') not in DEVICE_CATS or 'dur' not in e:
            continue
        s, end = max(e['ts'], w0), min(e['ts'] + e['dur'], w1)
        if end < s:
            continue
        intervals.append((s, end))
        host = launch.get((e.get('args') or {}).get('correlation'))
        sid = at(host) if host is not None else None
        add(sid, 'device_s', (end - s) / 1e6)
        for name in names(sid):
            rows[name]['ops'] += 1
            rows[name]['kernels'] += e['cat'] == 'kernel'
    gap_at = w0
    for s, e in _union(intervals) + [[w1, w1]]:
        if s > gap_at:
            add(at((gap_at + s) / 2), 'idle_s', (s - gap_at) / 1e6)
        gap_at = max(gap_at, e)
    own = _self_seconds(prog)
    for s in prog:
        row = rows[s.name]
        row['count'] += 1
        row['host_s'] += (s.end - s.start) / 1e6
        row['self_s'] += own[s.id]
    return ProgramTrace(prog, dict(recording.counts),
                        {k: dict(v) for k, v in sorted(rows.items())})


def row(program: Optional[ProgramTrace], name: str) -> Optional[Dict]:
    """The table's row of span ``name``; None where the run recorded no
    program spans or none of that name."""
    if program is None:
        return None
    return program.table.get(name)
