"""SEAN (Zhu et al., CVPR 2020) as the configuration states it: the
Zencoder and its masked region pool, and the SPADE/ACE generator, in
float32 over the state dict of the `sean.` family.

The style convolutions run over the dense D-channel style map, as SEAN
writes them (the program folds them through the region vectors, which is
exact by linearity).  `train=True` takes the batch's statistics in the
parameter-free norms; without it they take the running statistics.  ACE
noise is not modelled: the configurations run without it.
"""

from __future__ import annotations

from typing import Mapping

import torch

from benchmark.reference.nn import (
    FLOAT32, Numerics, batch_norm, conv, conv_transpose, instance_norm,
    lrelu, nearest, one_hot, upsample2x)


def encode(p: Mapping[str, torch.Tensor], cfg: Mapping, img: torch.Tensor,
           label: torch.Tensor, nx: Numerics = FLOAT32) -> torch.Tensor:
    """img [N,H,W,3] in [-1,1], label [N,H,W] -> codes [N,R,D]: the
    Zencoder's style map pooled over each region of the label (zero for a
    region the label does not hold)."""
    x = img.permute(0, 3, 1, 2)
    x = lrelu(instance_norm(conv(nx, p, 'zencoder.stem.conv', x, 1, 1,
                                 reflect=True)))
    x = lrelu(instance_norm(conv(nx, p, 'zencoder.down_0.conv', x, 2, 1)))
    x = lrelu(instance_norm(conv(nx, p, 'zencoder.down_1.conv', x, 2, 1)))
    x = lrelu(instance_norm(conv_transpose(nx, p, 'zencoder.up_0.conv', x,
                                           2, 1, 1)))
    code = torch.tanh(conv(nx, p, 'zencoder.out.conv', x, 1, 1,
                           reflect=True))
    seg = one_hot(nearest(label, code.shape[-1]), cfg['semantic_nc'])
    summed = torch.einsum('nrhw,ndhw->nrd', seg, code)
    area = seg.sum(dim=(2, 3))[..., None]
    return torch.where(area > 0, summed / area.clamp(min=1.0),
                       torch.zeros_like(summed))


def channels(cfg: Mapping):
    """Widths of the head and of each up block's output."""
    nf, n_up = cfg['ngf'], cfg['num_up_layers'] - 1
    return [16 * nf] + [nf * 2 ** (n_up - 1 - i) for i in range(n_up)]


def _ace(nx, p, name, cfg, x, seg, codes, styles: bool, train: bool):
    if cfg['param_free_norm'] == 'instance':
        normed = instance_norm(x)
    elif train:
        normed = batch_norm(x)
    else:
        normed = batch_norm(x, p[f'{name}.pfn.running_mean'],
                            p[f'{name}.pfn.running_var'])
    h = torch.relu(conv(nx, p, f'{name}.spade.mlp_shared.conv', seg, 1, 1))
    gamma_s = conv(nx, p, f'{name}.spade.mlp_gamma.conv', h, 1, 1)
    beta_s = conv(nx, p, f'{name}.spade.mlp_beta.conv', h, 1, 1)
    if not styles:
        return normed * (1 + gamma_s) + beta_s
    mu = torch.relu(torch.einsum('rio,nri->nro',
                                 nx.q(p[f'{name}.fc_mu_kernel']), nx.q(codes))
                    + p[f'{name}.fc_mu_bias'])
    middle = torch.einsum('nrhw,nrd->ndhw', seg, mu)
    gamma_a = conv(nx, p, f'{name}.conv_gamma.conv', middle, 1, 1)
    beta_a = conv(nx, p, f'{name}.conv_beta.conv', middle, 1, 1)
    ga = torch.sigmoid(p[f'{name}.blending_gamma'])
    ba = torch.sigmoid(p[f'{name}.blending_beta'])
    gamma = ga * gamma_a + (1 - ga) * gamma_s
    beta = ba * beta_a + (1 - ba) * beta_s
    return normed * (1 + gamma) + beta


def _block(nx, p, name, cfg, x, seg, codes, fin, fout, styles, train):
    a = lambda ace, t: _ace(nx, p, f'{name}.{ace}', cfg, t, seg, codes,
                            styles, train)
    dx = conv(nx, p, f'{name}.conv_0.conv', lrelu(a('ace_0', x)), 1, 1)
    dx = conv(nx, p, f'{name}.conv_1.conv', lrelu(a('ace_1', dx)), 1, 1)
    xs = x
    if fin != fout:
        xs = conv(nx, p, f'{name}.conv_s.conv', a('ace_s', x))
    return xs + dx


def decode(p: Mapping[str, torch.Tensor], cfg: Mapping, label: torch.Tensor,
           codes: torch.Tensor, train: bool = False,
           nx: Numerics = FLOAT32) -> torch.Tensor:
    """label [N,H,W] + codes [N,R,D] -> image [N,H,W,3] in [-1,1]."""
    r = cfg['semantic_nc']
    start = cfg['crop_size'] // 2 ** cfg['num_up_layers']
    segs = [one_hot(nearest(label, start * 2 ** i), r)
            for i in range(cfg['num_up_layers'] + 1)]
    g = 'generator'
    x = conv(nx, p, f'{g}.fc.conv', segs[0], 1, 1)
    w = 16 * cfg['ngf']
    x = _block(nx, p, f'{g}.head_0', cfg, x, segs[0], codes, w, w, True,
               train)
    x = upsample2x(x)
    for m in range(cfg['num_middle_blocks']):
        x = _block(nx, p, f'{g}.G_middle_{m}', cfg, x, segs[1], codes, w, w,
                   True, train)
    ch = channels(cfg)
    for i in range(len(ch) - 1):
        x = upsample2x(x)
        x = _block(nx, p, f'{g}.up_{i}', cfg, x, segs[2 + i], codes, ch[i],
                   ch[i + 1], i < len(ch) - 2, train)
    x = conv(nx, p, f'{g}.conv_img.conv', lrelu(x), 1, 1)
    return torch.tanh(x).permute(0, 2, 3, 1)
