"""The editor's timed path in float32: the EigenGAN colour/texture
generator, the shape VAE's mask decoders, the latent edits of the sliders
and sweeps, the SEAN render and the Poisson blend (elliptical morphology,
the gamma-2.2 system, a plain fixed-count CG).

Latents are dicts of [N, k] float32 tensors: hsv (uint8-range HSV),
pca_std, curliness, texture, shape, face.  `p` is the editor's whole
state dict; each function reads its own family (`ct_gen.`, `shape.`,
`sean.`, `style_fallback`).
"""

from __future__ import annotations

import math
from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import sean
from benchmark.reference.nn import (
    FLOAT32, Numerics, conv, dense, lrelu, sample_layer_norm, sub)

HAIR, BACKGROUND = 13, 0


# ---------------------------------------------------------------- colour
def hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    """uint8-range HSV (H in [0,180)) -> RGB rounded to the uint8 grid, by
    OpenCV's 8-bit rule (its float scalings by 1/30 and 1/255); float32."""
    h = hsv[..., 0] * (1.0 / 30.0)
    s = hsv[..., 1] * (1.0 / 255.0)
    v = hsv[..., 2]
    sector = torch.floor(h)
    f = h - sector
    p_, q_, t_ = v * (1 - s), v * (1 - s * f), v * (1 - s * (1 - f))
    k = torch.remainder(sector, 6)
    r = torch.where(k == 0, v, torch.where(k == 1, q_, torch.where(
        k == 2, p_, torch.where(k == 3, p_, torch.where(k == 4, t_, v)))))
    g = torch.where(k == 0, t_, torch.where(k == 1, v, torch.where(
        k == 2, v, torch.where(k == 3, q_, torch.where(k == 4, p_, p_)))))
    b = torch.where(k == 0, p_, torch.where(k == 1, p_, torch.where(
        k == 2, t_, torch.where(k == 3, v, torch.where(k == 4, v, q_)))))
    return torch.clamp(torch.round(torch.stack([r, g, b], -1)), 0, 255)


def rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    """RGB in [0,255] (not necessarily on the uint8 grid) -> uint8-range
    HSV by OpenCV's 8-bit rule, each channel truncated to an integer as a
    uint8 holds it; float32."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    v = torch.maximum(torch.maximum(r, g), b)
    diff = v - torch.minimum(torch.minimum(r, g), b)
    s = torch.where(v > 0, torch.round(255 * diff / torch.where(
        v > 0, v, torch.ones_like(v))), torch.zeros_like(v))
    safe = torch.where(diff > 0, diff, torch.ones_like(diff))
    hue = torch.where(v == r, g - b, torch.where(
        v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = torch.where(diff > 0, torch.round(30 * hue / safe),
                    torch.zeros_like(v))
    h = torch.where(h < 0, h + 180, h)
    h = torch.where(h >= 180, h - 180, h)
    return torch.floor(torch.stack([h, s, v], -1))


def gaussian_to_hsv(table: torch.Tensor, dim: int, val: float) -> torch.Tensor:
    """A colour slider's value -> the table's entry at the normal CDF's
    quantile (float32, as the UI's mapping computes it)."""
    cdf = torch.special.ndtr(torch.tensor(val, dtype=torch.float32))
    n = table.shape[0]
    idx = int(torch.clamp((cdf * n).to(torch.int32), 0, n - 1))
    return table[idx, dim]


# ---------------------------------------------------------------- sliders
def apply_direction(vec, direction, val):
    """Move `vec` along `direction` until its projection equals `val`."""
    proj = vec @ direction
    return vec + (val - proj)[:, None] * direction[None]


def apply_tick(latent: Dict[str, torch.Tensor], tick, table, shape_dirs,
               texture_dirs, max_fe: float = 2.5) -> Dict[str, torch.Tensor]:
    """One slider move (group, index, value) on a batch-1 latent."""
    group, idx, val = tick
    out = dict(latent)
    if group == 'color' and idx == 3:
        v = (val + max_fe) / 2 / max_fe
        out['pca_std'] = torch.full_like(latent['pca_std'], v * 100 + 20)
    elif group == 'color':
        hsv = latent['hsv'].clone()
        hsv[0, idx] = gaussian_to_hsv(table, idx, val).to(hsv.device)
        out['hsv'] = hsv
    elif group == 'curliness':
        out['curliness'] = torch.full_like(latent['curliness'], val)
    elif group == 'texture':
        out['texture'] = apply_direction(latent['texture'],
                                         texture_dirs[idx], val)
    elif group == 'shape':
        out['shape'] = apply_direction(latent['shape'], shape_dirs[idx], val)
    else:
        raise ValueError(group)
    return out


def interpolate(l1, l2, alphas: torch.Tensor):
    """Latents between l1 and l2 at each alpha [N]: colour through RGB,
    the rest linearly, the face l1's."""
    a = alphas[:, None]
    lerp = lambda x, y: x * (1 - a) + y * a
    rgb = lerp(hsv_to_rgb(l1['hsv']), hsv_to_rgb(l2['hsv']))
    n = alphas.shape[0]
    return {'hsv': rgb_to_hsv(rgb), 'pca_std': lerp(l1['pca_std'],
                                                    l2['pca_std']),
            'curliness': lerp(l1['curliness'], l2['curliness']),
            'texture': lerp(l1['texture'], l2['texture']),
            'shape': lerp(l1['shape'], l2['shape']),
            'face': l1['face'].expand(n, -1)}


# ------------------------------------------------------------------ models
def hair_feature(p, ct_cfg: Mapping, latent, nx: Numerics = FLOAT32):
    """EigenGAN: the condition MLP with a subspace injection a layer ->
    the hair's style code [N, D]."""
    g = sub(p, 'ct_gen.')
    layers = ct_cfg['g_hidden_layer_num']
    cond = torch.cat([latent['curliness'], hsv_to_rgb(latent['hsv']),
                      latent['pca_std']], -1)
    z = latent['texture'].reshape(-1, layers,
                                  ct_cfg['noise_dim'] // layers)
    x = dense(nx, g, 'main_in', cond)
    for i in range(layers):
        s = f'subspace_{i}'
        x = x + (g[f'{s}.L'] * z[:, i]) @ g[f'{s}.U'] + g[f'{s}.mu']
        x = dense(nx, g, f'main_mid_{i}', lrelu(x))
    return x


def _mask_decoder(nx, p, name, cfg, code):
    layers = cfg['layer_num']
    ch = min(32 * 2 ** layers, cfg['max_channel'])
    s = cfg['img_size'] // 2 ** layers
    x = dense(nx, p, f'{name}.in_layer.fc', code)
    x = x.reshape(-1, s, s, ch).permute(0, 3, 1, 2)
    for i in range(layers):
        x = F.interpolate(x, scale_factor=2, mode='nearest')
        x = conv(nx, p, f'{name}.up_{i}.conv.conv', x, 1, 1)
        x = lrelu(sample_layer_norm(p, f'{name}.up_{i}.norm', x))
    return conv(nx, p, f'{name}.out.conv.conv', x, 1, 1)


def mask_logits(p, shape_cfg: Mapping, shape_code, face_code,
                nx: Numerics = FLOAT32) -> torch.Tensor:
    """Shape and face codes -> the merged hair and face logits [N,19,S,S]
    (the decoded label is their argmax)."""
    s = sub(p, 'shape.')
    face = _mask_decoder(nx, s, 'face_decoder', shape_cfg, face_code)
    hair = _mask_decoder(nx, s, 'hair_decoder', shape_cfg,
                         torch.cat([face_code, shape_code], -1))
    return torch.cat([face[:, :HAIR], hair, face[:, HAIR:]], 1)


def label_gap(logits: torch.Tensor, label: torch.Tensor) -> float:
    """The widest gap, over the pixels, by which the logit of the class a
    label holds lies below the best logit (0 where the label is the
    argmax); a class outside the logits reads as infinitely far."""
    if label.min() < 0 or label.max() >= logits.shape[1]:
        return float('inf')
    chosen = logits.gather(1, label.long()[:, None])[:, 0]
    return float((logits.amax(dim=1) - chosen).max())


def render(p, sean_cfg: Mapping, codes, feature, label,
           nx: Numerics = FLOAT32):
    """The hair code swapped into the face's codes, regions without a code
    given the fallback, SEAN's decode -> [N,S,S,3] in [-1,1]."""
    codes = codes.clone()
    codes[:, HAIR] = feature
    has = torch.any(codes != 0, dim=-1, keepdim=True)
    codes = torch.where(has, codes, p['style_fallback'][None])
    return sean.decode(sub(p, 'sean.'), sean_cfg, label, codes, nx=nx)


# ------------------------------------------------------------------- blend
def ellipse(ksize: int) -> np.ndarray:
    """OpenCV's elliptical structuring element of a ksize square."""
    r = ksize // 2
    k = np.zeros((ksize, ksize), bool)
    for i in range(ksize):
        dy = i - r
        dx = r if dy == 0 else int(round(r * math.sqrt(
            max(0.0, 1.0 - dy * dy / (r * r)))))
        k[i, max(r - dx, 0):min(r + dx + 1, ksize)] = True
    return k


def dilate(mask: torch.Tensor, ksize: int) -> torch.Tensor:
    """Binary dilation of [N,H,W] over the ellipse, zero outside."""
    r = ksize // 2
    h, w = mask.shape[-2:]
    padded = F.pad(mask, (r, r, r, r))
    out = torch.zeros_like(mask)
    for dy, dx in zip(*np.nonzero(ellipse(ksize))):
        out = torch.maximum(out, padded[..., dy:dy + h, dx:dx + w])
    return out


def laplacian(x):
    """4x minus the four neighbours, zero outside the image."""
    p = F.pad(x, (1, 1, 1, 1))
    h, w = x.shape[-2:]
    return 4 * x - p[..., :h, 1:w + 1] - p[..., 2:, 1:w + 1] \
        - p[..., 1:h + 1, :w] - p[..., 1:h + 1, 2:]


def cg(b, unk, x0, iterations: int):
    """Fixed-count CG on v -> lap(v * unk) * unk, one solve an image."""
    a_op = lambda v: laplacian(v * unk) * unk
    dot = lambda a, c: (a * c).sum(dim=(1, 2, 3), keepdim=True)
    x = x0
    r = (b - a_op(x0)) * unk
    d = r
    rs = dot(r, r)
    for _ in range(iterations):
        ad = a_op(d)
        alpha = rs / (dot(d, ad) + 1e-20)
        x = x + alpha * d
        r = r - alpha * ad
        rs_new = dot(r, r)
        d = r + (rs_new / (rs + 1e-20)) * d
        rs = rs_new
    return x


def blend(face_u8, gen, face_label, target_label, iterations: int):
    """Poisson blend of the render into the face: the face keeps its
    gradients outside the hair of either label dilated by 13 px (5 px
    over the target's background); inside, the render is fixed.  Gamma
    2.2 around the solve; -> uint8 [N,S,S,3]."""
    hair = ((target_label == HAIR) | (face_label == HAIR)).float()
    bg = (target_label == BACKGROUND).float()
    keep = 1 - (dilate(hair, 13) * (1 - bg) + dilate(hair, 5) * bg)
    gamma = 2.2
    src = torch.clamp(face_u8.float(), min=0).permute(0, 3, 1, 2) ** (1 / gamma)
    tgt = torch.clamp(gen * 127.5 + 127.5, min=0).permute(0, 3, 1, 2) \
        ** (1 / gamma)
    n, _, h, w = src.shape
    m = (keep != 0)[:, None]
    interior = torch.zeros((h, w), dtype=torch.bool, device=src.device)
    interior[1:-1, 1:-1] = True
    fixed = ~m & interior
    unk = (~fixed).float()
    b = torch.where(m, laplacian(src), tgt)
    b_eff = (b - laplacian(torch.where(fixed, tgt, torch.zeros_like(tgt)))) \
        * unk
    x = cg(b_eff, unk.expand(-1, 3, -1, -1), src * unk, iterations)
    out = torch.clamp(torch.where(fixed, tgt, x), min=0) ** gamma
    out = torch.clamp(out, 0, 255).permute(0, 2, 3, 1)
    return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)


def edit(p, cfg: Mapping, codes, latent, face_u8, face_label, target_label,
         nx: Numerics = FLOAT32):
    """One batch of edits: feature, render under target_label, blend."""
    feature = hair_feature(p, cfg['color_texture'], latent, nx)
    gen = render(p, cfg['sean'], codes, feature, target_label, nx)
    return blend(face_u8, gen, face_label, target_label,
                 cfg['poisson_iterations'])
