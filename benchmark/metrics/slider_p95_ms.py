"""The 95th percentile of the slider requests' latency over the traced
window, by the host's clock (the request from apply_slider to the image on
the host).  A traced window runs under the profiler, which slows the
host's launches: this reads higher than an untraced run would."""

from benchmark.harness import percentile


def read(trace):
    lat = trace.counts.get('latencies_s')
    if not lat:
        return None
    return percentile(lat, 95) * 1e3
