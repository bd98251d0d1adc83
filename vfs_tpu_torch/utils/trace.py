"""Spans and counters inside the program, kept only while recording.

    from vfs_tpu_torch.utils import trace

    with trace.span('tracker.readback'):     # anywhere in the program
        preds = preds.cpu().numpy()
    trace.count('tracker.blocks')

    with trace.recording() as rec:          # whoever wants to see them
        single_process_test(model, dataset)
    rec.spans    # [Span(name, start_ns, end_ns, thread, parent, key, id)]
    rec.counts   # {'tracker.blocks': 36, ...}

Outside ``recording()`` a span costs one check of a module global and
hands back one shared null context: no clock read, no allocation. Inside
it, a span keeps its name, its start and end on ``time.time_ns()`` (the
wall clock, which a ``torch.profiler`` trace maps onto its own through
its ``baseTimeNanoseconds``), the thread it ran on
(``threading.get_ident()``), the id of the span open on that thread when
it began (``parent``) and ``key``, the identifier shared by the spans of
one request (the video index in the eval, the optimizer's update count
in training); a span given no key takes its parent's.

``recording(annotate=True)`` also opens a ``torch.profiler``
``record_function`` for each span, so a running profiler that records the
host's activity shows the spans beside the operators and kernels
(``tools.train --profile N``).

Spans in the program: ``test.decode``, ``test.preload`` (prefetch
thread), ``test.wait_input``, ``test.video`` (``apis/test.py``);
``tracker.extract``, ``tracker.labels``, ``tracker.propagate``,
``tracker.readback`` and the counter ``tracker.blocks``
(``models/trackers/vanilla_tracker.py``); the counters
``row1.rescored_pairs`` and ``row1.overflow_queries`` (row 1's
tensor-core path, ``ops/video_affinity.py``, added at the tracker's
readback); ``propagation.affinity``,
``propagation.labels`` (``ops/propagation.py``); ``train.step`` with
``train.h2d``, ``train.device_aug``, ``train.forward``,
``train.backward``, ``train.optimizer``, and ``train.wait_batch``
(``apis/train.py``); ``aug.draw``, ``aug.<transform>``, ``aug.normalise``
(``ops/device_aug.py``); ``slowfast.slow``, ``slowfast.fast``,
``slowfast.lateral`` and the counter ``slowfast.concat_bytes``
(``models/backbones/resnet3d_variants.py``); ``recognizer.head``
(``models/recognizers/recognizers.py``); ``optimizer.clip``
(``core/optimizer/builder.py``).
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Dict, Hashable, List, NamedTuple, Optional

__all__ = ['Span', 'Recording', 'span', 'count', 'active', 'recording']


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    thread: int
    parent: Optional[int]     # ``id`` of the enclosing span on the thread
    key: Optional[Hashable]
    id: int


class Recording:
    """What one ``recording()`` kept: ``spans`` in the order they ended,
    ``counts`` by name."""

    def __init__(self, annotate: bool = False):
        self.annotate = annotate
        self.spans: List[Span] = []
        self.counts: Dict[str, int] = {}
        self._ids = itertools.count()
        self._open = threading.local()
        self._lock = threading.Lock()

    def _stack(self) -> list:
        """The (id, key) of the spans open on the calling thread."""
        stack = getattr(self._open, 'stack', None)
        if stack is None:
            stack = self._open.stack = []
        return stack


_NULL = contextlib.nullcontext()
_active: Optional[Recording] = None


class _Open:
    """One span being recorded."""
    __slots__ = ('rec', 'name', 'key', 'id', 'parent', 'start',
                 'annotation')

    def __init__(self, rec: Recording, name: str, key):
        self.rec, self.name, self.key = rec, name, key

    def __enter__(self):
        stack = self.rec._stack()
        self.parent, inherited = stack[-1] if stack else (None, None)
        if self.key is None:
            self.key = inherited
        self.id = next(self.rec._ids)
        stack.append((self.id, self.key))
        self.annotation = None
        self.start = time.time_ns()
        if self.rec.annotate:
            import torch
            self.annotation = torch.profiler.record_function(self.name)
            self.annotation.__enter__()
        return self

    def __exit__(self, *exc):
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        end = time.time_ns()
        self.rec._stack().pop()
        self.rec.spans.append(Span(self.name, self.start, end,
                                   threading.get_ident(), self.parent,
                                   self.key, self.id))
        return False


def span(name: str, key: Optional[Hashable] = None):
    """A context manager that records ``name`` around its block while a
    ``recording()`` is open; ``key`` None takes the enclosing span's."""
    rec = _active
    if rec is None:
        return _NULL
    return _Open(rec, name, key)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while a ``recording()`` is open."""
    rec = _active
    if rec is None:
        return
    with rec._lock:
        rec.counts[name] = rec.counts.get(name, 0) + n


def active() -> bool:
    """Whether a ``recording()`` is open: code that would have to wait
    for the device to count something asks first."""
    return _active is not None


@contextlib.contextmanager
def recording(annotate: bool = False):
    """Record every span and counter of the process, on every thread,
    while the block runs; yields the ``Recording`` that holds them. One
    recording at a time: opening a second raises ``RuntimeError``.
    ``annotate`` also opens a profiler ``record_function`` per span."""
    global _active
    if _active is not None:
        raise RuntimeError('a trace recording is already open')
    rec = Recording(annotate)
    _active = rec
    try:
        yield rec
    finally:
        _active = None
