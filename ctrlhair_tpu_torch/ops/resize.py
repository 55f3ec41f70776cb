# Resizes with explicitly controlled sampling conventions.
#
# Port of ctrlhair_tpu/ops/resize.py.  Source indices and interpolation
# weights are computed in float32 exactly as the JAX twin computes them, so
# nearest resizes pick the same pixels and bilinear resizes apply the same
# weights.  `resize_nearest` and `resize_bilinear` work on the two trailing
# dims ([..., H, W], which covers NCHW); the *_nhwc variants keep the JAX
# package's channels-last layout at the public boundary.  The index and
# weight tensors are made on a device once per size and kept, so a resize
# copies nothing from the host after its first call (a CUDA graph captured
# over a training step, training/chunked.py, cannot copy from pageable host
# memory).

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def _src_index_nearest(dst_size: int, src_size: int) -> np.ndarray:
    # torch 'nearest' & cv2 INTER_NEAREST: src = floor(i * scale)
    scale = np.float32(src_size / dst_size)
    idx = np.floor(np.arange(dst_size, dtype=np.float32) * scale)
    return np.clip(idx.astype(np.int64), 0, src_size - 1)


@functools.lru_cache(maxsize=None)
@torch.inference_mode(False)
def _nearest_index(dst_size: int, src_size: int,
                   device: torch.device) -> torch.Tensor:
    # kept tensors are made outside inference mode, so a training step can
    # use one that an inference call made first
    return torch.as_tensor(_src_index_nearest(dst_size, src_size),
                           device=device)


def resize_nearest(img: torch.Tensor, out_hw) -> torch.Tensor:
    """Nearest resize of the two trailing dims of [..., H, W]."""
    h, w = out_hw
    h_in, w_in = img.shape[-2], img.shape[-1]
    if h_in % h == 0 and w_in % w == 0 and h <= h_in and w <= w_in:
        return img[..., ::h_in // h, ::w_in // w]
    iy = _nearest_index(h, h_in, img.device)
    ix = _nearest_index(w, w_in, img.device)
    return img.index_select(-2, iy).index_select(-1, ix)


def resize_nearest_nhwc(img: torch.Tensor, out_hw) -> torch.Tensor:
    """Nearest resize for [..., H, W, C] tensors."""
    return resize_nearest(img.movedim(-1, -3), out_hw).movedim(-3, -1)


def _linear_matrix(dst_size: int, src_size: int,
                   align_corners: bool) -> np.ndarray:
    """[dst, src] interpolation-weight matrix for one separable axis."""
    f32 = np.float32
    if align_corners and dst_size > 1:
        src = np.arange(dst_size, dtype=f32) * f32(
            (src_size - 1) / (dst_size - 1))
    else:
        scale = f32(src_size / dst_size)
        src = (np.arange(dst_size, dtype=f32) + f32(0.5)) * scale - f32(0.5)
    i0 = np.clip(np.floor(src), 0, src_size - 1)
    frac = np.clip(src - i0, f32(0.0), f32(1.0)).astype(f32)
    i0 = i0.astype(np.int64)
    i1 = np.clip(i0 + 1, 0, src_size - 1)
    rows = np.arange(dst_size)
    mat = np.zeros((dst_size, src_size), f32)
    np.add.at(mat, (rows, i0), f32(1.0) - frac)
    np.add.at(mat, (rows, i1), frac)
    return mat


@functools.lru_cache(maxsize=None)
@torch.inference_mode(False)
def _linear_weights(dst_size: int, src_size: int, align_corners: bool,
                    device: torch.device, dtype: torch.dtype
                    ) -> torch.Tensor:
    return torch.as_tensor(_linear_matrix(dst_size, src_size, align_corners),
                           device=device, dtype=dtype)


def resize_bilinear(img: torch.Tensor, out_hw,
                    align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize of the two trailing dims of [..., H, W].

    align_corners=False matches cv2.INTER_LINEAR / torch's default;
    align_corners=True matches the BiSeNet output upsample.  Two separable
    weight matmuls, as in the JAX twin; integer inputs compute in float32.
    """
    h, w = out_hw
    dtype = img.dtype if img.is_floating_point() else torch.float32
    x = img.to(dtype)
    wy = _linear_weights(h, x.shape[-2], align_corners, x.device, dtype)
    wx = _linear_weights(w, x.shape[-1], align_corners, x.device, dtype)
    x = torch.matmul(wy, x)                    # [..., h, W]
    return torch.matmul(x, wx.transpose(0, 1))  # [..., h, w]


def resize_bilinear_nhwc(img: torch.Tensor, out_hw,
                         align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize for [..., H, W, C] tensors."""
    return resize_bilinear(img.movedim(-1, -3), out_hw,
                           align_corners).movedim(-3, -1)


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """2x nearest upsample of NCHW (torch nn.Upsample(scale_factor=2))."""
    return F.interpolate(x, scale_factor=2, mode='nearest')


def upsample2x_nearest_nhwc(x: torch.Tensor) -> torch.Tensor:
    """2x nearest upsample of NHWC."""
    return upsample2x_nearest(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def downsample_label_pyramid(label: torch.Tensor, sizes):
    """Nearest-resize a [N, H, W] integer label map to each size in sizes.

    Nearest of a one-hot mask == one-hot of nearest labels.
    """
    return tuple(resize_nearest(label, (s, s)) for s in sizes)
