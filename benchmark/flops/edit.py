"""The editor's work: a render (EigenGAN's feature and SEAN's decode), a
mask decode (the shape VAE's two decoders) and the blend's CG solve."""

from typing import Mapping

from benchmark.flops import sean
from benchmark.flops.common import conv, dense

# masked CG: operations an iteration and element (the 5-point stencil 7,
# two dot products 4, three axpys 6), as csrc/masked_cg.cu states its bound
CG_OPS_PER_ELEMENT = 17


def feature(ct: Mapping, n: int) -> int:
    h, layers = ct['g_hidden_dim'], ct['g_hidden_layer_num']
    cond = ct['curliness_dim'] + 3 + 1
    total = dense(n, cond, h)
    for i in range(layers):
        total += dense(n, ct['noise_dim'] // layers, h)       # (L z) @ U
        total += dense(n, h, ct['style_dim'] if i == layers - 1 else h)
    return total


def render(cfg: Mapping, n: int) -> int:
    return feature(cfg['color_texture'], n) + sean.decode(cfg['sean'], n)


def _mask_decoder(sh: Mapping, n: int, in_dim: int, out_ch: int) -> int:
    layers, s = sh['layer_num'], sh['img_size'] // 2 ** sh['layer_num']
    ch = min(32 * 2 ** layers, sh['max_channel'])
    total = dense(n, in_dim, ch * s * s)
    for i in range(layers):
        out = min(32 * 2 ** (layers - 1 - i), sh['max_channel'])
        total += conv(n, ch, out, 3, (s * 2 ** (i + 1)) ** 2)
        ch = out
    return total + conv(n, ch, out_ch, 3, sh['img_size'] ** 2)


def decode_mask(cfg: Mapping, n: int) -> int:
    sh = cfg['shape']
    return (_mask_decoder(sh, n, sh['face_dim'], 18)
            + _mask_decoder(sh, n, sh['face_dim'] + sh['hair_dim'], 1))


def cg_work(n: int, c: int, h: int, w: int, iterations: int):
    """(operations, bytes) of one masked CG solve of [N,C,H,W]: the bytes
    b, the unknown mask and x0 read once and x written once."""
    elems = n * c * h * w
    return CG_OPS_PER_ELEMENT * iterations * elems, 4 * 4 * elems
