"""Seeded weights, drawn on the device by the benchmark itself.

`draw` fills a state dict of the given names and shapes from one uniform
draw on the device: each leaf is a view of that buffer, shifted and scaled
by a rule of its name and shape (`leaf_rule`).  The program and the
reference load the same dict; the program's own initialisers draw
nothing that is used.  Names are sorted before the buffer is split, so the
values of a leaf do not depend on the order in which a module lists its
parameters.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Mapping, Tuple

import torch


HAIR_LOGIT_SHIFT = 0.75
HAIR_BIAS = 'shape.hair_decoder.out.conv.conv.bias'
COND_LAYER = 'ct_gen.main_in.weight'


def leaf_rule(name: str, shape: Tuple[int, ...]) -> Tuple[float, float]:
    """(shift, scale) that maps u ~ U(-1, 1) to the leaf's values.

    Kernels: variance 1/fan_in (LeCun's), fan_in every input of an output
    unit (the stacked fc_mu kernel [R, D, D] counts R * D); EigenGAN's
    input layer 128 times smaller, as its conditions (RGB, pca_std) lie
    on the uint8 scale; the hair decoder's output bias shifted by
    HAIR_LOGIT_SHIFT, so that the mask a random decoder draws holds hair
    (a tenth to a half of the pixels at 128 px) and a slider's colour and
    texture reach the render;
    the EigenGAN subspace bases rows of unit scale; its per-basis scales
    in (1, 5); norm scales around 1 (the shape branch's gamma in (0, 1));
    running variances in (0.5, 1.5); biases, means, shifts and the style
    fallback small and centred."""
    leaf = name.rsplit('.', 1)[-1]
    if name == 'style_fallback':
        return 0.0, 0.5
    if leaf == 'running_var':
        return 1.0, 0.5
    if leaf in ('running_mean', 'mu', 'fc_mu_bias', 'noise_var'):
        return 0.0, 0.1
    if leaf in ('blending_gamma', 'blending_beta'):
        return 0.0, 1.0
    if leaf == 'L':
        return 3.0, 2.0
    if leaf == 'U':
        return 0.0, math.sqrt(3.0 / shape[1])
    if leaf == 'gamma':
        return 0.5, 0.5
    if name == HAIR_BIAS:
        return HAIR_LOGIT_SHIFT, 0.05
    if leaf in ('bias', 'beta'):
        return 0.0, 0.05
    if len(shape) >= 2:
        fan_in = math.prod(shape[1:])
        if leaf == 'fc_mu_kernel':
            fan_in = shape[0] * shape[1]
        scale = math.sqrt(3.0 / fan_in)
        return 0.0, scale / 128 if name == COND_LAYER else scale
    if leaf == 'weight':                 # a 1-d norm scale
        return 1.0, 0.1
    raise ValueError(f'no rule for {name} {shape}')


def draw(specs: Iterable[Tuple[str, Tuple[int, ...]]], seed: int,
         device) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor} for every (name, shape), from one seeded
    uniform draw on `device`."""
    specs = sorted((n, tuple(s)) for n, s in specs)
    total = sum(math.prod(s) for _, s in specs)
    gen = torch.Generator(device=device).manual_seed(seed)
    buf = torch.rand(total, generator=gen, device=device)
    buf.mul_(2.0).sub_(1.0)
    out, off = {}, 0
    for name, shape in specs:
        n = math.prod(shape)
        shift, scale = leaf_rule(name, shape)
        leaf = buf[off:off + n].view(shape)
        leaf.mul_(scale).add_(shift)
        out[name], off = leaf, off + n
    return out


def unit_vectors(sizes: Mapping[str, int], seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """{name: a unit vector of that size}, normal draws normalised (the
    spectral norm's power-iteration vectors)."""
    names = sorted(sizes)
    gen = torch.Generator(device=device).manual_seed(seed)
    buf = torch.randn(sum(sizes[n] for n in names), generator=gen,
                      device=device)
    out, off = {}, 0
    for n in names:
        v = buf[off:off + sizes[n]]
        out[n], off = v / torch.linalg.vector_norm(v), off + sizes[n]
    return out


def specs_of(state: Mapping[str, torch.Tensor], prefix: str = ''):
    """(name, shape) of every entry of a state dict, names prefixed; a
    non-float entry raises (the rules draw floats)."""
    out = []
    for k, v in state.items():
        if not v.is_floating_point():
            raise TypeError(f'{k}: {v.dtype} is not drawn')
        out.append((prefix + k, tuple(v.shape)))
    return out
