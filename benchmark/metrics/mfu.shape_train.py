"""The shape VAE-GAN's training steps' model FLOPs over the traced window
(every forward pass, a backward at twice the forward of each pass that is
differentiated, and the double backward of both critics' R0 penalties:
benchmark/flops/shape_train.py) against the card's float32 peak, in %."""

from benchmark import peaks


def read(trace):
    flops = trace.counts.get('model_flops', 0)
    if not flops or trace.window_s <= 0:
        return None
    return 100.0 * flops / trace.window_s / peaks.FLOPS['float32']
