# Image quality metrics for regression gating (the SSIM >= 0.99 criterion
# of BASELINE.md), batched.
#
# Port of ctrlhair_tpu/utils/metrics.py.  The Gaussian window is applied as
# two 'valid' 1-D passes of shifted slices, multiplied and added in float32,
# not as a conv2d: on a card cuDNN may run a float32 convolution in TF32
# (torch.backends.cudnn.allow_tf32 is True unless a caller turns it off),
# which would cut the window's products to a 10-bit mantissa.

from __future__ import annotations

import numpy as np
import torch


def _gaussian_1d(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    """The normalised 1-D window whose outer product is the JAX twin's
    2-D kernel."""
    x = np.arange(size) - (size - 1) / 2.0
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return g / g.sum()


def _filter2(img: torch.Tensor, g: np.ndarray) -> torch.Tensor:
    """'valid' separable correlation over the H, W dims of [..., H, W, C]."""
    k = len(g)
    h, w = img.shape[-3], img.shape[-2]
    rows = sum(float(g[i]) * img[..., i:h - k + 1 + i, :, :]
               for i in range(k))
    return sum(float(g[i]) * rows[..., :, i:w - k + 1 + i, :]
               for i in range(k))


def _as_f32(x) -> torch.Tensor:
    """A tensor stays on its device; anything else becomes a CPU tensor."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.from_numpy(np.array(x, dtype=np.float32))


def batch_ssim(a, b, data_range: float = 255.0) -> torch.Tensor:
    """Mean SSIM of [..., H, W, C] pairs over their last three dims
    (Gaussian 11x1.5 window, the standard Wang et al. convention used by
    skimage/scikit gates): [N,H,W,C] pairs -> [N]."""
    a, b = _as_f32(a), _as_f32(b)
    g = _gaussian_1d()
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    mu_a = _filter2(a, g)
    mu_b = _filter2(b, g)
    mu_aa = mu_a * mu_a
    mu_bb = mu_b * mu_b
    mu_ab = mu_a * mu_b
    s_aa = _filter2(a * a, g) - mu_aa
    s_bb = _filter2(b * b, g) - mu_bb
    s_ab = _filter2(a * b, g) - mu_ab
    num = (2 * mu_ab + c1) * (2 * s_ab + c2)
    den = (mu_aa + mu_bb + c1) * (s_aa + s_bb + c2)
    return (num / den).mean(dim=(-3, -2, -1))


def ssim(a, b, data_range: float = 255.0) -> torch.Tensor:
    """Mean SSIM over an [H, W, C] pair (0-d tensor)."""
    return batch_ssim(a, b, data_range)


def psnr(a, b, data_range: float = 255.0) -> torch.Tensor:
    mse = torch.mean((_as_f32(a) - _as_f32(b)) ** 2)
    return 10.0 * torch.log10(data_range ** 2 / torch.clamp(mse, min=1e-12))
