"""The program's own spans (ctrlhair_tpu_torch.utils.profiling) over a
traced window, as the readers of launch_idle_ms.edit, host_stage_ms.edit
and sync_wait_ms.edit take them.

The program records spans while a profiler runs, so in a `--trace 1` run
its records are those of the traced window.  A request root is a span
opened with none open on its thread, here one of ROOTS; the window's
roots are those that overlap the trace's span of time (its first harness
span or device operation to its last), and every span of their request
ids is read.  A stage counts only where no stage encloses it.  A program
without the recorder, or a window without images, gives the readers
nothing to read.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

ROOTS = ('backend.output', 'backend.output_batch', 'backend.sweep',
         'slider.apply')
STAGES = ('render', 'decode_mask', 'blend')
READBACK = 'readback'


def program_records() -> list:
    """The program's span records of this process, or [] where the
    program has no recorder."""
    from ctrlhair_tpu_torch.utils import profiling
    get = getattr(profiling, 'records', None)
    return list(get()) if get is not None else []


def time_range(trace) -> Optional[Tuple[int, int]]:
    ends = [(s, e) for _, s, e in trace.spans] + \
        [(o.start_ns, o.end_ns) for o in trace.ops]
    if not ends:
        return None
    return min(s for s, _ in ends), max(e for _, e in ends)


class Window:
    """The request roots of a traced window and the spans under them."""

    def __init__(self, trace, records: Optional[Sequence] = None):
        records = program_records() if records is None else records
        span = time_range(trace)
        self.roots = [r for r in records
                      if r.parent is None and r.name in ROOTS
                      and (span is None or (r.end_ns >= span[0]
                                            and r.start_ns <= span[1]))]
        ids = {r.request for r in self.roots}
        mine = [r for r in records if r.request in ids]
        by_id = {r.id: r for r in mine}

        def outermost(r) -> bool:
            p = r.parent
            while p is not None and p in by_id:
                if by_id[p].name in STAGES:
                    return False
                p = by_id[p].parent
            return True
        self.stages = sorted((r for r in mine
                              if r.name in STAGES and outermost(r)),
                             key=lambda r: r.start_ns)
        self.readbacks = [r for r in mine if r.name == READBACK]
        self.images = sum(r.attrs.get('images', 0) for r in self.roots)
        self.image_requests = sum(1 for r in self.roots
                                  if r.attrs.get('images', 0) > 0)

    def stage_at(self, starts: List[int], t: int) -> Optional[str]:
        """The outermost stage open on the host at time t, or None."""
        i = bisect.bisect_right(starts, t)
        for r in reversed(self.stages[max(0, i - 64):i]):
            if r.start_ns <= t <= r.end_ns:
                return r.name
        return None

    def idle_by_stage(self, ops) -> Dict[str, int]:
        """Idle ns between the device operations, each gap put down to the
        stage open on the host when it began (Trace.breakdown's rule);
        gaps that began outside every stage are left out."""
        starts = [r.start_ns for r in self.stages]
        out: Dict[str, int] = defaultdict(int)
        end = None
        for o in sorted(ops, key=lambda o: o.start_ns):
            if end is not None and o.start_ns > end:
                name = self.stage_at(starts, end)
                if name is not None:
                    out[name] += o.start_ns - end
            end = o.end_ns if end is None else max(end, o.end_ns)
        return dict(out)
