"""SEAN's encode and decode, as the configuration computes them (the
style convolutions folded through the region vectors when
fold_style_convs is set, over the dense style map when not)."""

from typing import Mapping

from benchmark.flops.common import conv


def _ace(cfg: Mapping, n: int, c: int, size: int, styles: bool) -> int:
    r, d, hid = cfg['semantic_nc'], cfg['style_dim'], cfg['spade_hidden']
    hw = size * size
    total = conv(n, r, hid, 3, hw) + 2 * conv(n, hid, c, 3, hw)
    if not styles:
        return total
    total += 2 * n * r * d * d                       # the 19 fc_mu layers
    if cfg['fold_style_convs']:
        # the kernel folded through each region vector, then a grouped
        # 3x3 conv of the one-hot: twice (gamma and beta)
        total += 2 * (2 * c * d * 9 * n * r + 2 * n * c * r * 9 * hw)
    else:
        total += 2 * n * hw * r * d + 2 * conv(n, d, c, 3, hw)
    return total


def _block(cfg, n, fin, fout, size, styles) -> int:
    mid = min(fin, fout)
    hw = size * size
    total = (_ace(cfg, n, fin, size, styles) + conv(n, fin, mid, 3, hw)
             + _ace(cfg, n, mid, size, styles) + conv(n, mid, fout, 3, hw))
    if fin != fout:
        total += _ace(cfg, n, fin, size, styles) + conv(n, fin, fout, 1, hw)
    return total


def decode(cfg: Mapping, n: int) -> int:
    nf, n_up = cfg['ngf'], cfg['num_up_layers'] - 1
    start = cfg['crop_size'] // 2 ** cfg['num_up_layers']
    chans = [16 * nf] + [nf * 2 ** (n_up - 1 - i) for i in range(n_up)]
    total = conv(n, cfg['semantic_nc'], 16 * nf, 3, start * start)
    total += _block(cfg, n, 16 * nf, 16 * nf, start, True)
    total += cfg['num_middle_blocks'] * _block(cfg, n, 16 * nf, 16 * nf,
                                               2 * start, True)
    for i in range(n_up):
        total += _block(cfg, n, chans[i], chans[i + 1],
                        4 * start * 2 ** i, i < n_up - 1)
    return total + conv(n, chans[-1], 3, 3, cfg['crop_size'] ** 2)


def encode(cfg: Mapping, n: int) -> int:
    s, z = cfg['crop_size'], cfg['zencoder_ngf']
    total = conv(n, 3, z, 3, s * s)
    total += conv(n, z, 2 * z, 3, (s // 2) ** 2)
    total += conv(n, 2 * z, 4 * z, 3, (s // 4) ** 2)
    total += conv(n, 4 * z, 8 * z, 3, (s // 4) ** 2)   # transposed: per input
    total += conv(n, 8 * z, cfg['style_dim'], 3, (s // 2) ** 2)
    return total + 2 * n * (s // 2) ** 2 * cfg['semantic_nc'] * \
        cfg['style_dim']
