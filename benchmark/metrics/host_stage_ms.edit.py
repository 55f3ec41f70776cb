"""Host ms per edited image inside the program's outermost stage spans
(render, decode_mask, blend) of the window's requests
(benchmark/spans.py): what the host pays to issue the stages."""

from benchmark.spans import Window


def read(trace):
    w = Window(trace)
    if not w.images:
        return None
    return sum(r.end_ns - r.start_ns for r in w.stages) / 1e6 / w.images
