"""Model operations of one SEAN training step: the forward passes, and a
backward counted at twice the forward of each pass that is
differentiated (G's encode and decode, both discriminator scales on the
fake and on the real, VGG19 on the fake); VGG19 on the real runs forward
only."""

from typing import Mapping

from benchmark.flops import sean
from benchmark.flops.common import conv, conv_out

VGG_CONVS = ((3, 64, 0), (64, 64, 0), (64, 128, 1), (128, 128, 1),
             (128, 256, 2), (256, 256, 2), (256, 256, 2), (256, 256, 2),
             (256, 512, 3), (512, 512, 3), (512, 512, 3), (512, 512, 3),
             (512, 512, 4))        # (in, out, pools before it)


def discriminator(tr: Mapping, cin: int, size: int, n: int) -> int:
    total = 0
    for _ in range(tr['dis_num_d']):
        s, c, ndf = size, cin, tr['dis_ndf']
        for j in range(tr['dis_n_layers']):
            out = ndf if j == 0 else min(ndf * 2 ** j, 512)
            stride = 1 if j == tr['dis_n_layers'] - 1 else 2
            s = conv_out(s, 4, stride, 2)
            total += conv(n, c, out, 4, s * s)
            c = out
        s = conv_out(s, 4, 1, 2)
        total += conv(n, c, 1, 4, s * s)
        size = conv_out(size, 3, 2, 1)               # the average pool
    return total


def vgg19(size: int, n: int) -> int:
    return sum(conv(n, cin, cout, 3, (size // 2 ** pools) ** 2)
               for cin, cout, pools in VGG_CONVS)


def step(cfg: Mapping, n: int) -> int:
    sc, tr = cfg['sean'], cfg['trainer']
    s = sc['crop_size']
    g = sean.encode(sc, n) + sean.decode(sc, n)
    d = 2 * discriminator(tr, sc['semantic_nc'] + 3, s, n)
    v = vgg19(s, n)
    return 3 * (g + d + v) + v
