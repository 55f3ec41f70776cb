"""Idle ms of the device per edited image, where the gap began while the
host was inside one of the program's stage spans (render, decode_mask,
blend: benchmark/spans.py): the device waiting on the stage's launches.
The split by stage goes to standard error."""

import sys

from benchmark.spans import Window


def read(trace):
    w = Window(trace)
    if not w.images or not trace.ops:
        return None
    by = w.idle_by_stage(trace.ops)
    print('[spans] launch idle by stage (s): ' + ', '.join(
        f'{k} {v / 1e9:.6f}' for k, v in sorted(by.items())) +
        f'; {w.images} images', file=sys.stderr)
    return sum(by.values()) / 1e6 / w.images
