# Latent hair representation + pure edit operators.
#
# Port of ctrlhair_tpu/pipeline/latent.py.  The latent is a frozen dataclass
# of float32 tensors; every edit returns a new Latent, and a batch of edits
# or an interpolation sweep is a batch dimension.

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ctrlhair_tpu_torch.constants import (
    CURLINESS_DIM, FACE_DIM, SHAPE_DIM, TEXTURE_DIM)
from ctrlhair_tpu_torch.utils.colorspace import hsv_to_rgb_u8, rgb_to_hsv_u8


@dataclasses.dataclass(frozen=True)
class Latent:
    """Disentangled hair latent.

    hsv: [N, 3] uint8-range floats; pca_std: [N, 1]; curliness: [N, 1];
    texture: [N, 8]; shape: [N, 16]; face: [N, 1024].
    """
    hsv: torch.Tensor
    pca_std: torch.Tensor
    curliness: torch.Tensor
    texture: torch.Tensor
    shape: torch.Tensor
    face: torch.Tensor

    @classmethod
    def zeros(cls, n: int = 1, device=None) -> 'Latent':
        z = lambda d: torch.zeros((n, d), device=device)
        return cls(hsv=z(3), pca_std=z(1), curliness=z(CURLINESS_DIM),
                   texture=z(TEXTURE_DIM), shape=z(SHAPE_DIM),
                   face=z(FACE_DIM))

    def replace(self, **changes) -> 'Latent':
        return dataclasses.replace(self, **changes)

    def map(self, fn) -> 'Latent':
        """Apply fn to every field."""
        return Latent(**{f.name: fn(getattr(self, f.name))
                         for f in dataclasses.fields(self)})

    def rgb_mean(self) -> torch.Tensor:
        """[N, 3] float RGB decoded from the stored uint8-range HSV."""
        return hsv_to_rgb_u8(self.hsv).to(torch.float32)


def set_component(latent: Latent, name: str, value: torch.Tensor) -> Latent:
    return latent.replace(**{name: value})


def apply_direction(vec: torch.Tensor, direction: torch.Tensor,
                    val) -> torch.Tensor:
    """Move `vec` so its projection on `direction` equals `val`."""
    proj = torch.einsum('nd,d->n', vec, direction)[:, None]
    return vec + (val - proj) * direction[None, :]


def projection(vec: torch.Tensor, direction: torch.Tensor) -> torch.Tensor:
    return torch.einsum('nd,d->n', vec, direction)


def interpolate_hsv(hsv1: torch.Tensor, hsv2: torch.Tensor,
                    alpha) -> torch.Tensor:
    """HSV interpolation through RGB space."""
    rgb1 = hsv_to_rgb_u8(hsv1).to(torch.float32)
    rgb2 = hsv_to_rgb_u8(hsv2).to(torch.float32)
    rgb = rgb1 * (1 - alpha) + rgb2 * alpha
    return rgb_to_hsv_u8(rgb).to(torch.float32)


def interpolate(l1: Latent, l2: Latent, alpha) -> Latent:
    """Full-latent interpolation; `face` stays l1's (the current face
    context)."""
    lerp = lambda a, b: a * (1 - alpha) + b * alpha
    return Latent(
        hsv=interpolate_hsv(l1.hsv, l2.hsv, alpha),
        pca_std=lerp(l1.pca_std, l2.pca_std),
        curliness=lerp(l1.curliness, l2.curliness),
        texture=lerp(l1.texture, l2.texture),
        shape=lerp(l1.shape, l2.shape),
        face=l1.face)


def interpolate_attribute(cur: Latent, l1: Latent, l2: Latent, alpha,
                          att_name: str) -> Latent:
    """Interpolate one attribute, keep the rest of `cur` (texture and
    curliness move together)."""
    lerp = lambda a, b: a * (1 - alpha) + b * alpha
    if att_name == 'shape':
        return cur.replace(shape=lerp(l1.shape, l2.shape))
    if att_name in ('curliness', 'texture'):
        return cur.replace(curliness=lerp(l1.curliness, l2.curliness),
                           texture=lerp(l1.texture, l2.texture))
    if att_name == 'color':
        return cur.replace(hsv=interpolate_hsv(l1.hsv, l2.hsv, alpha),
                           pca_std=lerp(l1.pca_std, l2.pca_std))
    raise ValueError(att_name)


def interpolate_triple(l1: Latent, l2: Latent, l3: Latent,
                       a1, a2, a3) -> Latent:
    """Two-lerp triple blend, as the reference computes it: the second lerp
    uses the raw a3, so (l1*a1 + l2*a2 + l3*a3)/sum only holds when the
    alphas sum to 1 (which is how the frontend calls it)."""
    l12 = interpolate(l1, l2, a2 / (a1 + a2))
    return interpolate(l12, l3, a3)


def transfer(cur: Latent, target: Latent, flag: str) -> Latent:
    """Copy one attribute group from target; texture carries curliness."""
    if flag == 'color':
        return cur.replace(hsv=target.hsv, pca_std=target.pca_std)
    if flag == 'texture':
        return cur.replace(texture=target.texture,
                           curliness=target.curliness)
    if flag == 'curliness':
        return cur.replace(curliness=target.curliness)
    if flag == 'shape':
        return cur.replace(shape=target.shape, face=target.face)
    raise ValueError(flag)


def stack_latents(latents: Sequence[Latent]) -> Latent:
    """Stack N single latents into one batched latent."""
    return Latent(**{f.name: torch.cat([getattr(l, f.name) for l in latents])
                     for f in dataclasses.fields(Latent)})


def semantic_directions(dim: int, count: int, seed: int = 7) -> np.ndarray:
    """Deterministic orthonormal directions: Gram-Schmidt against the set
    chosen so far, with the sign fixed so the largest entry is positive."""
    rng = np.random.default_rng(seed)
    dirs = []
    for _ in range(count):
        v = rng.standard_normal(dim)
        for d in dirs:
            v -= np.dot(v, d) * d
        v /= np.linalg.norm(v)
        if v[np.argmax(np.abs(v))] < 0:
            v = -v
        dirs.append(v)
    return np.stack(dirs).astype(np.float32)
