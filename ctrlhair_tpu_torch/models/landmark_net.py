# Learned facial-landmark regressor (the dlib stand-in).
#
# Port of ctrlhair_tpu/models/landmark_net.py: image -> 81 normalised
# landmarks + a face "presence" logit.  A stride-2 conv pyramid (stem, then
# `stages` pairs of a stride-2 and a stride-1 ConvBlock, instance norm and
# leaky ReLU), a flatten in the flax (NHWC) order, and an MLP head that
# predicts offsets from the canonical 81-point template:
# points = template + offset_range * tanh(raw).  Module names follow the
# flax ones, so convert.from_flax carries the shipped checkpoint across
# ({'landmark_net': {'params': ...}}).
# preprocess_image reproduces cv2.resize(..., INTER_AREA) on uint8 without
# cv2: a box mean for integer ratios (rounded half up at 2x, half to even
# otherwise, as cv2 rounds), cv2's fractional box weights for other
# downscales, pixel repetition for integer upscales, and cv2's 11-bit
# fixed-point linear weights for other upscales.

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn as nn

from ctrlhair_tpu_torch.models.layers import MLP, ConvBlock


@dataclasses.dataclass(frozen=True)
class LandmarkNetConfig:
    """Config for the landmark regressor (the inference fields of the JAX
    package's LandmarkNetConfig)."""
    input_size: int = 128      # images are resized to this before the net
    n_points: int = 81         # dlib 68 + 13 forehead points
    base_channels: int = 24
    stages: int = 4            # stride-2 stages after the stem
    hidden_dim: int = 256
    norm: str = 'in'
    offset_range: float = 0.5  # max offset from the template


class LandmarkNet(nn.Module):
    """[N,S,S,3] image in [-1,1] (NHWC, float32) -> {'landmarks': [N,81,2] in
    template units, 'presence': [N] logit}."""

    def __init__(self, cfg: LandmarkNetConfig = LandmarkNetConfig()):
        super().__init__()
        from ctrlhair_tpu_torch.ops.landmarks import canonical_template_81
        self.cfg = cfg
        ch = cfg.base_channels
        self.stem = ConvBlock(3, ch, 7, 2, pad=3, norm=cfg.norm,
                              activation='lrelu')
        for i in range(cfg.stages):
            out = min(ch * 2, 256)
            self.add_module(f'down_{i}', ConvBlock(
                ch, out, 3, 2, pad=1, norm=cfg.norm, activation='lrelu'))
            self.add_module(f'res_{i}', ConvBlock(
                out, out, 3, 1, pad=1, norm=cfg.norm, activation='lrelu'))
            ch = out
        side = cfg.input_size // 2 ** (cfg.stages + 1)
        self.head = MLP(side * side * ch, cfg.hidden_dim, 2,
                        cfg.n_points * 2 + 1, activation='lrelu')
        self.register_buffer('template', torch.as_tensor(
            canonical_template_81()[:cfg.n_points], dtype=torch.float32),
            persistent=False)

    def forward(self, img: torch.Tensor):
        cfg = self.cfg
        x = self.stem(img.permute(0, 3, 1, 2))
        for i in range(cfg.stages):
            x = getattr(self, f'res_{i}')(getattr(self, f'down_{i}')(x))
        # flatten in the flax order (NHWC), which the head was trained on
        out = self.head(x.permute(0, 2, 3, 1).reshape(x.shape[0], -1))
        raw = out[:, :cfg.n_points * 2].reshape(-1, cfg.n_points, 2)
        pts = self.template[None] + cfg.offset_range * torch.tanh(raw)
        return {'landmarks': pts, 'presence': out[:, -1]}


def _area_weights(src: int, dst: int) -> np.ndarray:
    """[dst, src] float32 weights of cv2's INTER_AREA downscale
    (computeResizeAreaTab): each output cell averages the source interval
    [dx*scale, (dx+1)*scale), partial pixels by their covered fraction."""
    scale = src / dst
    w = np.zeros((dst, src), np.float32)
    for dx in range(dst):
        f1 = dx * scale
        f2 = f1 + scale
        cell = min(scale, src - f1)
        s2 = min(int(np.floor(f2)), src - 1)
        s1 = min(int(np.ceil(f1)), s2)
        if s1 - f1 > 1e-3:
            w[dx, s1 - 1] = (s1 - f1) / cell
        w[dx, s1:s2] = 1.0 / cell
        if f2 - s2 > 1e-3:
            w[dx, s2] = min(f2 - s2, 1.0, cell) / cell
    return w


def _linear_weights(src: int, dst: int) -> np.ndarray:
    """[dst, src] int64 weights (summing to 2048 a row) of cv2's INTER_AREA
    upscale: linear interpolation at the fraction
    fx = (dx+1) - (sx+1)*dst/src (0 when negative), in 11-bit fixed point."""
    w = np.zeros((dst, src), np.int64)
    for dx in range(dst):
        sx = int(np.floor(dx * src / dst))
        fx = (dx + 1) - (sx + 1) * dst / src
        fx = 0.0 if fx <= 0 else fx - np.floor(fx)
        c0 = int(round(float(np.float32(1.0 - fx)) * 2048))
        if sx >= src - 1:
            w[dx, src - 1] = 2048
        else:
            w[dx, sx], w[dx, sx + 1] = c0, 2048 - c0
    return w


def area_resize_u8(img: np.ndarray, size: int) -> np.ndarray:
    """[H,W,C] uint8 -> [size,size,C] uint8, as
    cv2.resize(img, (size, size), interpolation=cv2.INTER_AREA)."""
    img = np.asarray(img, np.uint8)
    h, w = img.shape[:2]
    if (h, w) == (size, size):
        return img.copy()
    if h >= size and w >= size:
        if h % size == 0 and w % size == 0:
            ky, kx = h // size, w // size
            s = img.reshape(size, ky, size, kx, -1).astype(np.int64).sum(
                axis=(1, 3))
            if ky == kx == 2:
                return ((s + 2) >> 2).astype(np.uint8)
            mean = s.astype(np.float32) * np.float32(1.0 / (ky * kx))
            return np.rint(mean).astype(np.uint8)
        wy, wx = _area_weights(h, size), _area_weights(w, size)
        out = np.einsum('yh,hxc->yxc', wy,
                        np.einsum('xw,hwc->hxc', wx, img.astype(np.float32)))
        return np.clip(np.rint(out), 0, 255).astype(np.uint8)
    if h <= size and w <= size and size % h == 0 and size % w == 0:
        return img.repeat(size // h, axis=0).repeat(size // w, axis=1)
    if h > size or w > size:
        raise ValueError(f'area_resize_u8: {h}x{w} -> {size} shrinks one '
                         'axis and grows the other')
    wy, wx = _linear_weights(h, size), _linear_weights(w, size)
    rows = np.einsum('xw,hwc->hxc', wx, img.astype(np.int64))
    out = (np.einsum('yh,hxc->yxc', wy, rows) + (1 << 21)) >> 22
    return np.clip(out, 0, 255).astype(np.uint8)


def preprocess_image(img_uint8: np.ndarray, size: int) -> np.ndarray:
    """HWC uint8 RGB -> [1,S,S,3] float32 in [-1,1]."""
    img = area_resize_u8(img_uint8, size)
    return (img.astype(np.float32) / 127.5 - 1.0)[None]
