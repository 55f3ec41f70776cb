"""The training steps' model FLOPs over the traced window (forward, and a
backward at twice the forward of what is differentiated:
benchmark/flops/sean_train.py) against the card's float32 peak, in %."""

from benchmark import peaks


def read(trace):
    flops = trace.counts.get('model_flops', 0)
    if not flops or trace.window_s <= 0:
        return None
    return 100.0 * flops / trace.window_s / peaks.FLOPS['float32']
