"""Host ms per request inside the program's readback spans, over the
window's requests that return images (benchmark/spans.py): the device's
lag that the host waits out at the request's one sync."""

from benchmark.spans import Window


def read(trace):
    w = Window(trace)
    if not w.image_requests:
        return None
    return sum(r.end_ns - r.start_ns for r in w.readbacks) / 1e6 \
        / w.image_requests
