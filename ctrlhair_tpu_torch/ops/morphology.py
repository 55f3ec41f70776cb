# Binary morphology with cv2-elliptical structuring elements.
#
# Port of ctrlhair_tpu/ops/morphology.py: the footprint is decomposed into
# per-row horizontal spans (built by doubling) and a vertical shift-combine,
# all shifted elementwise max/min.  Exact against cv2 and against the JAX
# twin, batched over any leading dims of [..., H, W].

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def ellipse_kernel(ksize: int) -> np.ndarray:
    """cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (ksize, ksize)).

    OpenCV's scan-line ellipse fill: row dy has half-width
    round(c * sqrt(1 - dy^2/r^2)), the centre row the full width.
    """
    r = c = ksize // 2
    inv_r2 = 1.0 / (r * r) if r > 0 else 0.0
    kernel = np.zeros((ksize, ksize), np.float32)
    for i in range(ksize):
        dy = i - r
        if abs(dy) <= r:
            if dy == 0:
                dx = c
            else:
                dx = int(round(c * np.sqrt(max(0.0, 1.0 - dy * dy * inv_r2))))
            kernel[i, max(c - dx, 0):min(c + dx + 1, ksize)] = 1.0
    kernel.setflags(write=False)
    return kernel


def _shift(x: torch.Tensor, d: int, dim: int, fill: float) -> torch.Tensor:
    """Shift x by d along dim (positive = towards higher index), filling
    vacated entries with `fill` (cv2's constant-border semantics)."""
    if d == 0:
        return x
    n = x.shape[dim]
    k = x.dim() - 1 - dim           # F.pad lists the last dim first
    pad = [0, 0] * (k + 1)
    lo = 2 * k
    if d > 0:
        pad[lo] = d
        return F.pad(x, pad, value=fill).narrow(dim, 0, n)
    pad[lo + 1] = -d
    return F.pad(x, pad, value=fill).narrow(dim, -d, n)


def _ellipse_filter(x: torch.Tensor, ksize: int, combine,
                    fill: float) -> torch.Tensor:
    """min/max filter of [..., H, W] over the elliptical footprint."""
    kern = ellipse_kernel(ksize)
    r = ksize // 2
    h_dim, w_dim = x.dim() - 2, x.dim() - 1

    # each ellipse row is a centred run of width 2*dx+1 -> group rows by dx
    dx_rows = {}
    for i in range(ksize):
        width = int(kern[i].sum())
        if width > 0:
            dx_rows.setdefault((width - 1) // 2, []).append(i - r)

    def span(dx):
        """combine over horizontal offsets [-dx, dx], by doubling."""
        halves = []
        for sign in (-1, 1):
            acc, length = x, 1
            while length < dx + 1:
                step = min(length, dx + 1 - length)
                acc = combine(acc, _shift(acc, sign * step, w_dim, fill))
                length += step
            halves.append(acc)
        return combine(halves[1], halves[0])

    out = None
    for dx, dys in sorted(dx_rows.items()):
        hm = span(dx)
        for dy in dys:
            t = _shift(hm, dy, h_dim, fill)
            out = t if out is None else combine(out, t)
    return out


def dilate(mask: torch.Tensor, ksize: int, iterations: int = 1
           ) -> torch.Tensor:
    """Binary dilation of a [..., H, W] {0,1} mask with an ellipse kernel
    (cv2.dilate zero-border semantics)."""
    out = mask.to(torch.float32)
    for _ in range(iterations):
        out = _ellipse_filter(out, ksize, torch.maximum, 0.0)
    return out


def erode(mask: torch.Tensor, ksize: int, iterations: int = 1
          ) -> torch.Tensor:
    """Binary erosion of a [..., H, W] {0,1} mask with an ellipse kernel.

    Border fill is 1 (outside counts as foreground), matching cv2.erode's
    default border: a region touching the frame keeps its edge band."""
    out = mask.to(torch.float32)
    for _ in range(iterations):
        out = _ellipse_filter(out, ksize, torch.minimum, 1.0)
    return out
