"""Seeded inputs of the editing sessions: painted parses, faces painted
from them, latents, slider directions and the colour sliders' HSV table.

`paint_label` is a frozen copy of chip_smoke.paint_face: a CelebA-style
parse with a face, its features and a hair cap at face-proportional
places.  Host draws come from numpy generators; images are painted on the
device.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

LABELS = ['background', 'skin_other', 'nose', 'eye_g', 'l_eye', 'r_eye',
          'l_brow', 'r_brow', 'l_ear', 'r_ear', 'mouth', 'u_lip', 'l_lip',
          'hair', 'hat', 'ear_r', 'neck_l', 'neck', 'cloth']
IDX = {name: i for i, name in enumerate(LABELS)}
# a base colour a class (RGB) the painted faces start from
CLASS_RGB = np.array([
    [90, 110, 140], [224, 180, 150], [210, 160, 130], [40, 40, 40],
    [250, 250, 250], [250, 250, 250], [70, 50, 40], [70, 50, 40],
    [215, 170, 140], [215, 170, 140], [120, 40, 40], [180, 90, 90],
    [180, 90, 90], [60, 40, 30], [30, 30, 80], [200, 200, 50],
    [200, 160, 130], [205, 165, 135], [40, 60, 120]], np.float32)


def paint_label(size: int, cx: float, cy: float, scale: float,
                device) -> torch.Tensor:
    """A parse [size, size] int32: background, neck, a hair cap, a skin
    ellipse, brows, eyes, nose and mouth; (cx, cy) the face centre and
    `scale` its size, in fractions of the image."""
    ys, xs = torch.meshgrid(
        torch.arange(size, dtype=torch.float32, device=device) / size,
        torch.arange(size, dtype=torch.float32, device=device) / size,
        indexing='ij')
    lab = torch.zeros((size, size), dtype=torch.int32, device=device)
    fw, fh = 0.26 * scale, 0.34 * scale

    def ellipse(ex, ey, rx, ry, name):
        lab[((xs - ex) / rx) ** 2 + ((ys - ey) / ry) ** 2 <= 1] = IDX[name]

    lab[(ys > cy) & ((xs - cx).abs() < 0.5 * fw)] = IDX['neck']
    ellipse(cx, cy - 0.06 * scale, fw * 1.25, fh * 1.15, 'hair')
    ellipse(cx, cy, fw, fh, 'skin_other')
    lab[(ys < cy - 0.24 * scale) & (lab == IDX['skin_other'])] = IDX['hair']
    ex, ey = 0.45 * fw, cy - 0.30 * fh
    for side, sign in (('l', -1), ('r', 1)):
        ellipse(cx + sign * ex, ey, 0.17 * fw, 0.05 * fh, f'{side}_eye')
        ellipse(cx + sign * ex, ey - 0.14 * fh, 0.22 * fw, 0.02 * fh,
                f'{side}_brow')
    ellipse(cx, cy + 0.05 * fh, 0.13 * fw, 0.22 * fh, 'nose')
    my = cy + 0.55 * fh
    ellipse(cx, my - 0.03 * fh, 0.30 * fw, 0.045 * fh, 'u_lip')
    ellipse(cx, my + 0.03 * fh, 0.30 * fw, 0.045 * fh, 'l_lip')
    ellipse(cx, my, 0.24 * fw, 0.022 * fh, 'mouth')
    return lab


def paint_face(label: torch.Tensor, rng: np.random.Generator) -> torch.Tensor:
    """An RGB face [S, S, 3] uint8 painted from a parse: each class's base
    colour shifted per face, a low-frequency shading (8 px cells, bilinear)
    and pixel noise."""
    s = label.shape[-1]
    device = label.device
    colours = CLASS_RGB + rng.uniform(-25, 25, CLASS_RGB.shape)
    base = torch.as_tensor(colours, dtype=torch.float32,
                           device=device)[label.long()]
    cells = torch.as_tensor(rng.uniform(-20, 20, (1, 3, s // 8, s // 8)),
                            dtype=torch.float32, device=device)
    shade = torch.nn.functional.interpolate(cells, size=(s, s),
                                            mode='bilinear',
                                            align_corners=False)
    noise = torch.as_tensor(rng.normal(0, 4, (s, s, 3)), dtype=torch.float32,
                            device=device)
    img = base + shade[0].permute(1, 2, 0) + noise
    return torch.clamp(torch.round(img), 0, 255).to(torch.uint8)


def session_face(size: int, rng: np.random.Generator, device):
    """(face [S,S,3] uint8, parse [S,S] int32) of one session."""
    label = paint_label(size, rng.uniform(0.45, 0.55), rng.uniform(0.5, 0.6),
                        rng.uniform(0.9, 1.1), device)
    return paint_face(label, rng), label


def latent(rng: np.random.Generator, dims: Dict[str, int],
           n: int = 1) -> Dict[str, np.ndarray]:
    """A latent of n rows: HSV on the uint8 grid (H below 180), pca_std in
    [20, 120] (the variance slider's range), the rest standard normal."""
    out = {'hsv': np.stack([rng.integers(0, 180, n), rng.integers(0, 256, n),
                            rng.integers(0, 256, n)], -1),
           'pca_std': rng.uniform(20, 120, (n, 1))}
    for key in ('curliness', 'texture', 'shape', 'face'):
        out[key] = rng.standard_normal((n, dims[key]))
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


def directions(rng: np.random.Generator, dim: int, count: int) -> np.ndarray:
    """`count` orthonormal rows of width `dim`."""
    q, _ = np.linalg.qr(rng.standard_normal((dim, count)))
    return np.ascontiguousarray(q.T, np.float32)


def hsv_table(n: int = 4096) -> np.ndarray:
    """Column-wise sorted quantiles (H, S, V) for the colour sliders: the
    port's broad prior over hair colours (utils/color_stats._default_table,
    frozen here)."""
    q = (np.arange(n) + 0.5) / n
    h = 179.0 * q ** 2.2 * 0.35
    s = 255.0 * q ** 0.9
    v = 255.0 * (0.05 + 0.9 * q)
    return np.stack([h, s, v], axis=1).astype(np.float32)
