"""The whole edit's model FLOPs over the traced window (renders, mask
decodes and CG solves, counted from shapes by benchmark/flops/edit.py)
against the card's bfloat16 peak, in %."""

from benchmark import peaks


def read(trace):
    flops = trace.counts.get('model_flops', 0)
    if not flops or trace.window_s <= 0:
        return None
    return 100.0 * flops / trace.window_s / peaks.FLOPS['bfloat16']
