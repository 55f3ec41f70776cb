# Timing / tracing harness.
#
# Port of ctrlhair_tpu/utils/profiling.py (which supersedes the reference's
# wall-clock context manager, ref: my_pylib/timer.py:5-40): device-aware
# timing (torch.cuda.synchronize() before the clock is read, so that
# asynchronous launches do not lie), percentile stats, and one-call
# torch.profiler capture written as a Chrome trace.

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch


def _sync() -> None:
    """Wait for every launch queued on the card, if CUDA is in use."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Timer:
    """Context manager: `with Timer('render') as t: ...` prints seconds."""

    def __init__(self, msg: str = '', verbose: bool = True,
                 sync: bool = True):
        self.msg = msg
        self.verbose = verbose
        self.sync = sync
        self.elapsed = 0.0

    def __enter__(self):
        if self.sync:
            _sync()
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.sync:
            _sync()
        self.elapsed = time.perf_counter() - self.start
        if self.verbose:
            print(f'[timer] {self.msg}: {self.elapsed:.4f}s')
        return False


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
