# Timing, tracing and the program's spans.
#
# Port of ctrlhair_tpu/utils/profiling.py (which supersedes the reference's
# wall-clock context manager, ref: my_pylib/timer.py:5-40): device-aware
# timing (torch.cuda.synchronize() before the clock is read, so that
# asynchronous launches do not lie), percentile stats, and one-call
# torch.profiler capture written as a Chrome trace.
#
# Spans.  The edit path opens span(name) at its layer boundaries: a
# request on the Backend or a slider move (the request roots), the
# editor's render, mask decode and blend (the stages), and each read of a
# request's images or mask back to the host (readback).  A span records
# its name, request id, parent, thread, integer attributes such as
# `images`, and its start and end in ns from time.time_ns(), the clock on
# which torch.profiler stamps host events, so that spans and a profiler's
# device records line up without conversion.  Recording is on while a
# torch.profiler session runs or inside recording(); then each span also
# opens a torch.profiler.record_function named ctrlhair.<name>, which puts
# the program's stages over the kernels in trace()'s Chrome trace.  Off,
# a span costs one check and records nothing.  Records stay in memory, at
# most MAX_RECORDS of them (later ones are counted in dropped()), until
# clear().

from __future__ import annotations

import contextlib
import itertools
import os
import tempfile
import threading
import time
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch


def _sync() -> None:
    """Wait for every launch queued on the card, if CUDA is in use."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def benchmark(fn: Callable, *args, iters: int = 20, warmup: int = 3,
              **kwargs) -> Dict[str, float]:
    """Steady-state timing of a callable, each call ended by a
    synchronisation with the card."""
    for _ in range(warmup):
        fn(*args, **kwargs)
        _sync()
    times: List[float] = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args, **kwargs)
        _sync()
        times.append(time.perf_counter() - t0)
    arr = np.asarray(times)
    return {'mean_s': float(arr.mean()), 'p50_s': float(np.median(arr)),
            'p90_s': float(np.percentile(arr, 90)),
            'min_s': float(arr.min()), 'iters': iters}


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Capture a torch.profiler trace (host, and the card when CUDA is in
    use) around a block; written to <log_dir>/trace.json for
    chrome://tracing or Perfetto.  log_dir defaults to ctrlhair_trace under
    the temporary directory."""
    from torch.profiler import ProfilerActivity, profile
    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), 'ctrlhair_trace')
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        try:
            yield log_dir
        finally:
            _sync()
    prof.export_chrome_trace(os.path.join(log_dir, 'trace.json'))


# ------------------------------------------------------------------- spans
MAX_RECORDS = 1 << 20
PREFIX = 'ctrlhair.'


class SpanRecord(NamedTuple):
    name: str
    request: int              # the request id, that of the root above
    id: int
    parent: Optional[int]     # the id of the enclosing span; None: a root
    thread: int
    start_ns: int             # time.time_ns(), the profiler's host clock
    end_ns: int
    attrs: Dict[str, int]


_records: List[SpanRecord] = []
_dropped = 0
_switch = 0                   # recording() blocks open
_lock = threading.Lock()
_local = threading.local()
_span_ids = itertools.count(1)
_request_ids = itertools.count(1)
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ('name', 'attrs', 'id', 'parent', 'request', 'start_ns',
                 '_mirror')

    def __init__(self, name: str, attrs: Dict[str, int]):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        stack = getattr(_local, 'stack', None)
        if stack is None:
            stack = _local.stack = []
        self.id = next(_span_ids)
        if stack:
            self.parent, self.request = stack[-1].id, stack[-1].request
        else:
            self.parent, self.request = None, next(_request_ids)
        stack.append(self)
        self.start_ns = time.time_ns()
        self._mirror = torch.profiler.record_function(PREFIX + self.name)
        self._mirror.__enter__()
        return self

    def __exit__(self, *exc):
        global _dropped
        self._mirror.__exit__(*exc)
        end_ns = time.time_ns()
        _local.stack.pop()
        rec = SpanRecord(self.name, self.request, self.id, self.parent,
                         threading.get_ident(), self.start_ns, end_ns,
                         self.attrs)
        with _lock:
            if len(_records) < MAX_RECORDS:
                _records.append(rec)
            else:
                _dropped += 1
        return False


def span(name: str, **attrs: int):
    """Context manager around one layer of the program.  A span opened
    with no span open on its thread is a request root and takes a new
    request id; spans nested under it carry that id and their parent's."""
    if _switch or torch.autograd._profiler_enabled():
        return _Span(name, attrs)
    return _OFF


@contextlib.contextmanager
def recording():
    """Record spans inside this block, with no profiler running."""
    global _switch
    with _lock:
        _switch += 1
    try:
        yield
    finally:
        with _lock:
            _switch -= 1


def records() -> List[SpanRecord]:
    """The spans recorded so far, in the order they ended (a snapshot; the
    store is kept)."""
    with _lock:
        return list(_records)


def dropped() -> int:
    """Spans not kept because the store held MAX_RECORDS."""
    return _dropped


def clear() -> None:
    global _dropped
    with _lock:
        _records.clear()
        _dropped = 0
