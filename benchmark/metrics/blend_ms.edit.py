"""Device ms per image of the kernels launched inside the harness's span
around the editor's blend (HairEditor._blend: morphology, the Poisson
system and the masked-CG kernel K1)."""


def read(trace):
    images = trace.counts.get('images', 0)
    s = trace.span_device_s('blend')
    if not images or s <= 0:
        return None
    return s * 1e3 / images
