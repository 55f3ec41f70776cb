"""What every driver shares: the run's context, the caches kept inside the
checkout, the look for JAX, the tail statistics and the comparison's
report."""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import sys
from typing import Any, Dict, List, Optional, Sequence

FORBIDDEN_MODULES = ('jax', 'jaxlib', 'flax', 'ctrlhair_tpu')


@dataclasses.dataclass
class Context:
    """One run: the command line, the cell's entries of BENCHMARK.json,
    its configuration, traffic and limits, the device, and the clock at
    the process's first statement."""
    root: str
    workload: str
    seed: int
    seconds: float
    trace: bool
    cell: Dict[str, Any]
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, float]
    device: Any
    t_process: float
    # calibration only: also read the control and the planted faults
    control: bool = False


@dataclasses.dataclass
class Outcome:
    """What a driver hands back."""
    attempted: int
    failed: int
    checks: Dict[str, Dict[str, float]]   # name -> {'value', 'limit'}
    memory_peak_bytes: int
    e2e: Dict[str, float] = dataclasses.field(default_factory=dict)
    trace: Any = None
    readings: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return self.failed == 0 and bool(self.checks) and all(
            math.isfinite(c['value']) and c['value'] <= c['limit']
            for c in self.checks.values())


def quiet_collector() -> None:
    """Collect once and freeze what set-up left (the request streams, the
    models), so that the window's collections walk only what the window
    makes."""
    gc.collect()
    gc.freeze()


def cache_dirs(root: str) -> Dict[str, str]:
    """Build and kernel caches, at fixed paths inside the checkout (the
    port's own kernels build into ctrlhair_tpu_torch/_build there)."""
    base = os.path.join(root, '.bench_cache')
    return {'TORCH_EXTENSIONS_DIR': os.path.join(base, 'torch_extensions'),
            'TRITON_CACHE_DIR': os.path.join(base, 'triton'),
            'CUDA_CACHE_PATH': os.path.join(base, 'cuda')}


def prepare_environment(root: str) -> None:
    """Set the cache directories and keep libraries from loading JAX;
    called before torch is imported."""
    os.environ.update(cache_dirs(root))
    os.environ['USE_FLAX'] = '0'
    os.environ['USE_JAX'] = '0'


def one_core() -> int:
    """Run this process on one CPU, the highest-numbered it may use, with
    one thread for the host's math libraries; called before torch is
    imported.  The machine's CPUs are shared with other work, and a
    host-paced cell read 22 to 29 images/s from run to run with the
    process free to move, 24 to 26 pinned (benchmark on one H100 host)."""
    os.environ['OMP_NUM_THREADS'] = '1'
    os.environ['MKL_NUM_THREADS'] = '1'
    cpu = max(os.sched_getaffinity(0))
    os.sched_setaffinity(0, {cpu})
    return cpu


def forbidden_loaded() -> List[str]:
    """Top-level names in sys.modules that the run may not load, compared
    whole (ctrlhair_tpu_torch is not ctrlhair_tpu)."""
    tops = {name.split('.', 1)[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN_MODULES)


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0..100) by linear interpolation between order
    statistics (numpy's default)."""
    xs = sorted(values)
    if not xs:
        return float('nan')
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def check(value: float, limit: float) -> Dict[str, float]:
    return {'value': float(value), 'limit': float(limit)}


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)
