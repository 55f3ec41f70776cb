# FFHQ-style face alignment crop (host math).
#
# Port of ctrlhair_tpu/ops/crop.py (parity target of both:
# external_code/crop.py:20-107, recreate_aligned_images): an oriented crop
# quad from the eye and mouth landmarks, shrink, crop, reflect-pad with a
# blurred feather and a median pull for out-of-bounds regions, quad
# resample, landmark reprojection.  Every step takes the branch the JAX
# package takes without cv2: the bilinear quad sample is a numpy gather, the
# feather blur scipy.ndimage.gaussian_filter, the shrink the bilinear resize
# of ops/resize.py (on CPU tensors).  The stage stays on the host, as in the
# JAX package: its shapes depend on the data.

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ctrlhair_tpu_torch.ops.resize import resize_bilinear_nhwc


def crop_quad_from_landmarks(lm_68: np.ndarray) -> Tuple[np.ndarray, float]:
    """Oriented crop rectangle from 68 landmarks (ref: crop.py:32-49).

    Returns (quad [4,2] = NW,SW,SE,NE in source pixels, qsize).
    """
    lm = np.asarray(lm_68, np.float64)
    eye_left = lm[36:42].mean(0)
    eye_right = lm[42:48].mean(0)
    eye_avg = (eye_left + eye_right) * 0.5
    eye_to_eye = eye_right - eye_left
    mouth_avg = (lm[48] + lm[54]) * 0.5
    eye_to_mouth = mouth_avg - eye_avg

    x = eye_to_eye - np.flipud(eye_to_mouth) * [-1, 1]
    x /= np.hypot(*x)
    x *= max(np.hypot(*eye_to_eye) * 2.0, np.hypot(*eye_to_mouth) * 1.8)
    y = np.flipud(x) * [-1, 1]
    c = eye_avg + eye_to_mouth * 0.1
    quad = np.stack([c - x - y, c - x + y, c + x + y, c + x - y])
    qsize = np.hypot(*x) * 2
    return quad, float(qsize)


def _quad_sample(img: np.ndarray, quad: np.ndarray, out_size: int,
                 supersample: int = 2) -> np.ndarray:
    """Bilinear sample of `img` over the quad (NW,SW,SE,NE), box-filtered
    from a supersampled grid: the antialiasing the reference gets from its
    4096 px intermediate and ANTIALIAS downscale.  Edges replicate."""
    s = out_size * supersample
    u = (np.arange(s, dtype=np.float32) + 0.5) / s
    uu, vv = np.meshgrid(u, u)             # uu: x across, vv: y down
    nw, sw, se, ne = [np.asarray(q, np.float32) for q in quad]
    top = nw[None, None] * (1 - uu[..., None]) + ne[None, None] * uu[..., None]
    bot = sw[None, None] * (1 - uu[..., None]) + se[None, None] * uu[..., None]
    src = top * (1 - vv[..., None]) + bot * vv[..., None]   # [s,s,2] x,y

    h, w = img.shape[:2]
    xf = src[..., 0] - 0.5
    yf = src[..., 1] - 0.5
    x0 = np.clip(np.floor(xf), 0, w - 1).astype(np.int32)
    y0 = np.clip(np.floor(yf), 0, h - 1).astype(np.int32)
    x1 = np.clip(x0 + 1, 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    fx = np.clip(xf - x0, 0, 1)[..., None]
    fy = np.clip(yf - y0, 0, 1)[..., None]
    imf = img.astype(np.float32)
    out = (imf[y0, x0] * (1 - fx) * (1 - fy) + imf[y0, x1] * fx * (1 - fy)
           + imf[y1, x0] * (1 - fx) * fy + imf[y1, x1] * fx * fy)
    if supersample > 1:
        out = out.reshape(out_size, supersample, out_size, supersample,
                          -1).mean(axis=(1, 3))
    return out


def _perspective_from_quad(quad: np.ndarray) -> np.ndarray:
    """Homography mapping quad (NW,SW,SE,NE) -> unit square corners
    ((0,0),(0,1),(1,1),(1,0)), the cv2.getPerspectiveTransform analogue
    (ref: crop.py:101-102)."""
    src = np.asarray(quad, np.float64)
    dst = np.array([[0, 0], [0, 1], [1, 1], [1, 0]], np.float64)
    a, b = [], []
    for (sx, sy), (dx, dy) in zip(src, dst):
        a.append([sx, sy, 1, 0, 0, 0, -dx * sx, -dx * sy])
        a.append([0, 0, 0, sx, sy, 1, -dy * sx, -dy * sy])
        b.extend([dx, dy])
    h = np.linalg.solve(np.asarray(a), np.asarray(b))
    return np.append(h, 1.0).reshape(3, 3)


def _gaussian_blur(img: np.ndarray, sigma: float) -> np.ndarray:
    """Per-channel gaussian blur, scipy.ndimage semantics (reflect border,
    truncate 4)."""
    if sigma <= 0:
        return img
    import scipy.ndimage
    return scipy.ndimage.gaussian_filter(img, [sigma, sigma, 0])


def _shrink(img: np.ndarray, rsize: Tuple[int, int]) -> np.ndarray:
    """uint8 [H,W,3] -> uint8 [rsize] by the bilinear resize, rounded."""
    out = resize_bilinear_nhwc(torch.as_tensor(img, dtype=torch.float32)[None],
                               rsize)[0]
    return torch.clamp(torch.round(out), 0, 255).to(torch.uint8).numpy()


def recreate_aligned_image(img: np.ndarray, lm_68: np.ndarray,
                           output_size: int = 1024,
                           enable_padding: bool = True
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Align + crop a face image; returns (aligned uint8, landmarks_68).

    The reference's stage order (ref: crop.py:20-107): shrink large
    sources, crop to the quad's box, reflect-pad + gaussian feather + median
    pull where the quad leaves the image, quad resample, projective
    landmark reprojection.
    """
    img = np.asarray(img)
    quad, qsize = crop_quad_from_landmarks(lm_68)
    points = np.asarray(lm_68, np.float64)

    # shrink
    shrink = int(np.floor(qsize / output_size * 0.5))
    if shrink > 1:
        rsize = (int(np.rint(img.shape[0] / shrink)),
                 int(np.rint(img.shape[1] / shrink)))
        img = _shrink(img, rsize)
        quad = quad / shrink
        qsize /= shrink
        points = points / shrink

    # crop
    border = max(int(np.rint(qsize * 0.1)), 3)
    crop = (int(np.floor(quad[:, 0].min())), int(np.floor(quad[:, 1].min())),
            int(np.ceil(quad[:, 0].max())), int(np.ceil(quad[:, 1].max())))
    crop = (max(crop[0] - border, 0), max(crop[1] - border, 0),
            min(crop[2] + border, img.shape[1]),
            min(crop[3] + border, img.shape[0]))
    if crop[2] - crop[0] < img.shape[1] or crop[3] - crop[1] < img.shape[0]:
        img = img[crop[1]:crop[3], crop[0]:crop[2]]
        quad = quad - crop[0:2]
        points = points - np.array([crop[0], crop[1]])

    # pad
    pad = (int(np.floor(quad[:, 0].min())), int(np.floor(quad[:, 1].min())),
           int(np.ceil(quad[:, 0].max())), int(np.ceil(quad[:, 1].max())))
    pad = (max(-pad[0] + border, 0), max(-pad[1] + border, 0),
           max(pad[2] - img.shape[1] + border, 0),
           max(pad[3] - img.shape[0] + border, 0))
    if enable_padding and max(pad) > border - 4:
        pad = np.maximum(pad, int(np.rint(qsize * 0.3)))
        imgf = np.pad(np.float32(img),
                      ((pad[1], pad[3]), (pad[0], pad[2]), (0, 0)),
                      'reflect')
        points = points + np.array([pad[0], pad[1]])
        h, w, _ = imgf.shape
        yg, xg, _ = np.ogrid[:h, :w, :1]
        mask = np.maximum(
            1.0 - np.minimum(np.float32(xg) / max(pad[0], 1),
                             np.float32(w - 1 - xg) / max(pad[2], 1)),
            1.0 - np.minimum(np.float32(yg) / max(pad[1], 1),
                             np.float32(h - 1 - yg) / max(pad[3], 1)))
        blur = qsize * 0.02
        imgf += (_gaussian_blur(imgf, blur)
                 - imgf) * np.clip(mask * 3.0 + 1.0, 0.0, 1.0)
        # the per-channel median on a strided grid (>= 256k samples): it
        # only sets the far-field fill colour
        step = max(1, int(np.sqrt(h * w / 262144.0)))
        med = np.median(imgf[::step, ::step], axis=(0, 1))
        imgf += (med - imgf) * np.clip(mask, 0, 1)
        img = np.uint8(np.clip(np.rint(imgf), 0, 255))
        quad = quad + pad[:2]

    # resample + landmark reprojection
    out = _quad_sample(np.asarray(img), quad + 0.5, output_size)
    out = np.clip(np.rint(out), 0, 255).astype(np.uint8)
    hmat = _perspective_from_quad(quad + 0.5)
    hom = np.concatenate([points, np.ones((len(points), 1))], 1) @ hmat.T
    points = (hom[:, :2] / hom[:, 2:]) * output_size
    points = (points + 0.5).astype(np.int32)
    return out, points[:68]
