"""Kernel launches on the device per edited image over the traced window
(the profiler's kernel records)."""


def read(trace):
    images = trace.counts.get('images', 0)
    kernels = len(trace.kernels())
    if not images or not kernels:
        return None
    return kernels / images
