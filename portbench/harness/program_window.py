"""``traced()`` with the program's own spans and counters: the same
profiled window (``trace.traced``: the card's activity, the benchmark's
spans, the window span, the queue drained at both ends), and inside it a
``vfs_tpu_torch.utils.trace.recording()``. Afterwards ``out['trace']``
holds the read ``trace.Trace`` and ``out['program']`` the
``program_trace.ProgramTrace`` of the same events, or None where the
program has no recording to open.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
from typing import Dict, List

import torch

from . import program_trace
from .trace import WINDOW_SPAN, _span, _Spans, read


@contextlib.contextmanager
def _recording():
    """The program's recording, or None where it has none."""
    try:
        from vfs_tpu_torch.utils.trace import recording
    except ImportError:
        yield None
        return
    with recording() as rec:
        yield rec


@contextlib.contextmanager
def program_window(device, out: Dict):
    """Profile the block as ``trace.traced`` does, recording the
    program's spans and counters over it (module docstring)."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.device(device).type == 'cuda'
    activities = [ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]
    if cuda:
        torch.cuda.synchronize()
    spans: List = []
    with profile(activities=activities) as prof:
        with _recording() as rec:
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
    on_clock = [(n, a - base_us, b - base_us, tid) for n, a, b, tid in spans]
    out['trace'] = read(exported['traceEvents'], on_clock)
    out['program'] = None if rec is None else program_trace.read(
        exported['traceEvents'], on_clock, rec, base_us)
