"""The share of the traced window in which no operation ran on the
device: the window less the union of the kernel, memcpy and memset
intervals, in %."""


def read(trace):
    return trace.idle_percent()
