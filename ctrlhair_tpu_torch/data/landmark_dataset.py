# Synthetic training data for the landmark regressor.
#
# Port of ctrlhair_tpu/data/landmark_dataset.py: procedurally rendered
# faces with exact landmark ground truth (a similarity transform and per-
# group jitter of the canonical 81-point geometry, then the face regions
# painted as filled polygons with random colours, lighting, sensor noise
# and a blur), and cluttered backgrounds without a face for the presence
# head.  The JAX package paints with cv2.fillPoly, cv2.ellipse and
# cv2.GaussianBlur; the port paints with utils/draw.py, its numpy
# reproduction of those three, so it imports no cv2.  Every rng draw is
# made in JAX's order (cv2 draws nothing), so one seed gives JAX's faces:
# the landmarks and the presence exactly, the images as utils/draw.py
# states.

from __future__ import annotations

from typing import Dict

import numpy as np

from ctrlhair_tpu_torch.ops.landmarks import canonical_template_81
from ctrlhair_tpu_torch.utils.draw import blur3, fill_ellipse, fill_poly

_JAW = np.arange(0, 17)
_BROW_L = np.arange(17, 22)
_BROW_R = np.arange(22, 27)
_NOSE = np.arange(27, 36)
_EYE_L = np.arange(36, 42)
_EYE_R = np.arange(42, 48)
_MOUTH_OUT = np.arange(48, 60)
_MOUTH_IN = np.arange(60, 68)
_HAIRLINE = np.arange(68, 81)


def transform_landmarks(rng: np.random.Generator,
                        scale=(0.75, 1.2), rot_deg=25.0,
                        shift=0.10, jitter=0.008) -> np.ndarray:
    """Sample a perturbed face geometry: [81,2] in [0,1] units."""
    pts = canonical_template_81().astype(np.float64)
    c = pts.mean(0)
    s = rng.uniform(*scale)
    th = np.deg2rad(rng.uniform(-rot_deg, rot_deg))
    rot = np.array([[np.cos(th), -np.sin(th)],
                    [np.sin(th), np.cos(th)]])
    out = (pts - c) @ (s * rot).T + c + rng.uniform(-shift, shift, 2)
    # small independent per-group deformation (face shapes vary)
    for grp in (_JAW, _BROW_L, _BROW_R, _NOSE, _EYE_L, _EYE_R,
                np.concatenate([_MOUTH_OUT, _MOUTH_IN]), _HAIRLINE):
        g = out[grp]
        gc = g.mean(0)
        out[grp] = gc + (g - gc) * rng.uniform(0.9, 1.1, 2)
    out += rng.normal(0, jitter, out.shape)
    return out.astype(np.float32)


def _poly(img, pts, color, size):
    p = np.round(np.asarray(pts) * size).astype(np.int32)
    fill_poly(img, p, color)


def render_face(lm: np.ndarray, rng: np.random.Generator,
                size: int = 128) -> np.ndarray:
    """[81,2] landmarks -> HWC uint8 RGB rendering with those landmarks."""
    img = background(rng, size)
    skin = rng.uniform(100, 230, 3)
    hair = rng.uniform(10, 200, 3)
    lips = np.clip(skin * rng.uniform(0.5, 0.8) + np.array([60, 0, 0]),
                   0, 255)
    dark = rng.uniform(10, 90, 3)

    # hair: an expanded band behind the face, above the hairline and down
    # the jaw sides
    c = lm[_NOSE].mean(0)
    face_outline = np.concatenate([lm[_JAW], lm[_HAIRLINE][::-1]], 0)
    hair_outline = c + (face_outline - c) * rng.uniform(1.10, 1.35)
    _poly(img, hair_outline, hair.tolist(), size)
    # face: the jaw (chin path) up the sides, closed by the hairline arc
    _poly(img, face_outline, skin.tolist(), size)
    for grp in (_BROW_L, _BROW_R):
        b = lm[grp]
        band = np.concatenate([b + [0, -0.008], b[::-1] + [0, 0.008]], 0)
        _poly(img, band, dark.tolist(), size)
    _poly(img, lm[_EYE_L], dark.tolist(), size)
    _poly(img, lm[_EYE_R], dark.tolist(), size)
    nose_shadow = np.clip(skin * 0.85, 0, 255)
    _poly(img, lm[_NOSE], nose_shadow.tolist(), size)
    _poly(img, lm[_MOUTH_OUT], lips.tolist(), size)
    # lighting gradient, sensor noise, blur
    yy = np.linspace(-1, 1, size)[:, None, None]
    gain = 1.0 + rng.uniform(-0.15, 0.15) * yy
    img = np.clip(img.astype(np.float32) * gain, 0, 255)
    img += rng.normal(0, rng.uniform(2, 9), img.shape)
    return blur3(np.clip(img, 0, 255).astype(np.uint8))


def background(rng: np.random.Generator, size: int) -> np.ndarray:
    """Cluttered no-face background (negatives for the presence head)."""
    base = rng.uniform(0, 255, 3)
    tilt = rng.uniform(-80, 80, 3)
    yy = np.linspace(0, 1, size)[:, None, None]
    img = np.clip(base + tilt * yy + rng.normal(0, 6, (size, size, 3)),
                  0, 255).astype(np.uint8)
    for _ in range(rng.integers(0, 5)):
        # the draws in the order cv2.ellipse's arguments take them
        center = (int(rng.uniform(0, size)), int(rng.uniform(0, size)))
        axes = (int(rng.uniform(4, size // 3)),
                int(rng.uniform(4, size // 3)))
        angle = float(rng.uniform(0, 180))
        fill_ellipse(img, center, axes, angle,
                     rng.uniform(0, 255, 3).tolist())
    return img


def training_batch(rng: np.random.Generator, batch: int, size: int = 128,
                   neg_frac: float = 0.2) -> Dict[str, np.ndarray]:
    """{'image' [N,S,S,3] f32 in [-1,1], 'landmarks' [N,81,2],
    'presence' [N] f32}; the landmarks of a negative are the template
    (the presence mask keeps them out of the coordinate loss)."""
    imgs = np.empty((batch, size, size, 3), np.float32)
    lms = np.empty((batch, 81, 2), np.float32)
    pres = np.empty((batch,), np.float32)
    template = canonical_template_81()
    for i in range(batch):
        if rng.uniform() < neg_frac:
            imgs[i] = background(rng, size).astype(np.float32)
            lms[i] = template
            pres[i] = 0.0
        else:
            lm = transform_landmarks(rng)
            imgs[i] = render_face(lm, rng, size).astype(np.float32)
            lms[i] = np.clip(lm, 0.0, 1.0)
            pres[i] = 1.0
    imgs = imgs / 127.5 - 1.0
    return {'image': imgs, 'landmarks': lms, 'presence': pres}
