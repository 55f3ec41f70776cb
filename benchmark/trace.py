"""The traced window: torch.profiler over the requests or steps of a
`--trace 1` run, reduced to what the per-layer readers take.

Device operations are the profiler's kernel, memcpy and memset records.
Each is tied to the host call that launched it by its correlation id, and
through the launch's host time to the harness's span (a
torch.profiler.record_function range opened by the benchmark's own code)
that held it.  The device is busy over the union of the operations'
intervals; the window is the host time from the first traced request to
the synchronisation after the last.
"""

from __future__ import annotations

import bisect
import sys
import time
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional, Sequence

import torch

SPAN_PREFIX = 'bench.'


class Op(NamedTuple):
    name: str
    kind: str           # 'kernel', 'gpu_memcpy' or 'gpu_memset'
    start_ns: int
    end_ns: int
    span: Optional[str]  # the harness span the launch lay in, or None


class Trace:
    """What a reader takes: the device operations of the window, its
    length, the host spans, and the counts of the work done in it that
    the cell's driver module hands over (images, steps, model FLOPs,
    kernel shapes)."""

    def __init__(self, ops: List[Op], window_s: float,
                 spans: List[tuple], counts: Dict):
        self.ops, self.window_s = ops, window_s
        self.spans, self.counts = spans, counts

    def kernels(self) -> List[Op]:
        return [o for o in self.ops if o.kind == 'kernel']

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device: the union of
        the operations' intervals."""
        total, end = 0, None
        for o in sorted(self.ops, key=lambda o: o.start_ns):
            if end is None or o.start_ns > end:
                total += o.end_ns - o.start_ns
                end = o.end_ns
            elif o.end_ns > end:
                total += o.end_ns - end
                end = o.end_ns
        return total / 1e9

    def idle_percent(self) -> Optional[float]:
        if self.window_s <= 0 or not self.ops:
            return None
        return 100.0 * max(0.0, self.window_s - self.busy_s()) / self.window_s

    def span_device_s(self, span: str) -> float:
        return sum(o.end_ns - o.start_ns for o in self.ops
                   if o.kind == 'kernel' and o.span == span) / 1e9

    def breakdown(self) -> Dict[str, list]:
        """The ten device operations that took most time (summed by name),
        and the idle time between operations summed by the harness span
        the host was in when the gap began (or 'outside spans')."""
        by_name = defaultdict(int)
        for o in self.ops:
            by_name[o.name] += o.end_ns - o.start_ns
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = defaultdict(int)
        ops = sorted(self.ops, key=lambda o: o.start_ns)
        starts = [s[1] for s in self.spans]
        end = None
        for o in ops:
            if end is not None and o.start_ns > end:
                gaps[self._span_at(starts, end)] += o.start_ns - end
            end = o.end_ns if end is None else max(end, o.end_ns)
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
        return {'device_ops': [[n[:120], ns / 1e9] for n, ns in top],
                'idle_gaps': [[n, ns / 1e9] for n, ns in idle]}

    def _span_at(self, starts: Sequence[int], t: int) -> str:
        """The innermost harness span open at host time t."""
        best = None
        i = bisect.bisect_right(starts, t)
        for name, s, e in reversed(self.spans[max(0, i - 64):i]):
            if s <= t <= e and (best is None or s > best[1]):
                best = (name, s, e)
        return best[0] if best else 'outside spans'


class Tracer:
    """Profiles the traced window.  with Tracer(device) as tr: ... ; then
    tr.finish(counts) -> Trace."""

    def __init__(self, device: torch.device):
        self.device = device
        self._prof = None
        self.window_s = 0.0

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == 'cuda':
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize(self.device)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        self.window_s = time.perf_counter() - self._t0
        t0 = time.perf_counter()
        self._prof.__exit__(*exc)
        self.stop_s = time.perf_counter() - t0
        return False

    def finish(self, counts: Dict) -> Trace:
        """Reduce the profiler's records: device operations (a device's
        records other than annotations; 'Memcpy ...' and 'Memset ...' by
        their names), the runtime calls that launched them (host records
        named cuda* or cu*, tied by correlation id), and the harness's
        spans (host annotations named bench.*)."""
        t0 = time.perf_counter()
        cpu = torch.autograd.DeviceType.CPU
        launch_ns, spans, raw = {}, [], []
        for e in self._prof.profiler.kineto_results.events():
            name = e.name()
            if e.device_type() != cpu:
                if e.is_user_annotation():
                    continue
                kind = ('gpu_memcpy' if name.startswith('Memcpy') else
                        'gpu_memset' if name.startswith('Memset') else
                        'kernel')
                raw.append((name, kind, e.start_ns(),
                            e.start_ns() + e.duration_ns(),
                            e.correlation_id()))
            elif e.is_user_annotation():
                if name.startswith(SPAN_PREFIX):
                    spans.append((name[len(SPAN_PREFIX):], e.start_ns(),
                                  e.start_ns() + e.duration_ns()))
            elif name.startswith('cu'):
                launch_ns[e.correlation_id()] = e.start_ns()
        spans.sort(key=lambda s: s[1])
        starts = [s[1] for s in spans]
        probe = Trace([], 0.0, spans, {})
        ops = []
        for name, kind, s, t, corr in raw:
            host = launch_ns.get(corr)
            span = None if host is None else probe._span_at(starts, host)
            ops.append(Op(name, kind, s, t, None if span == 'outside spans'
                          else span))
        print(f'[trace] window {self.window_s:.3f} s, profiler stop '
              f'{self.stop_s:.3f} s, reduction {time.perf_counter() - t0:.3f}'
              f' s, {len(ops)} device operations', file=sys.stderr)
        return Trace(ops, self.window_s, spans, counts)


def span(name: str):
    """A harness span around a call into a layer of the program."""
    return torch.profiler.record_function(SPAN_PREFIX + name)
