"""Device ms per image of the kernels launched inside the harness's span
around the editor's render (HairEditor._edit_render: EigenGAN feature,
SEAN decode)."""


def read(trace):
    images = trace.counts.get('images', 0)
    s = trace.span_device_s('render')
    if not images or s <= 0:
        return None
    return s * 1e3 / images
