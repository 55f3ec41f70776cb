"""Host ms a training step inside the program's outermost `train.inputs`
spans (training/chunked.ChunkRunner: each step's make_batch, make_draws
and copies into the graph's input slots) that overlap the traced window,
over the window's steps.  Nothing where the program records no such span,
as a program without them."""

from benchmark import spans

NAME = 'train.inputs'


def read(trace):
    steps = trace.counts.get('steps', 0)
    window = spans.time_range(trace)
    records = spans.program_records()
    by_id = {r.id: r for r in records}

    def outermost(r) -> bool:
        p = r.parent
        while p is not None and p in by_id:
            if by_id[p].name == NAME:
                return False
            p = by_id[p].parent
        return True
    inputs = [r for r in records if r.name == NAME and outermost(r)
              and (window is None or (r.end_ns >= window[0]
                                      and r.start_ns <= window[1]))]
    if not inputs or not steps:
        return None
    return sum(r.end_ns - r.start_ns for r in inputs) / 1e6 / steps
