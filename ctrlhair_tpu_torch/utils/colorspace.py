# uint8 HSV <-> RGB conversions with OpenCV's 8-bit rules, as torch ops.
#
# Port of ctrlhair_tpu/utils/colorspace.py: H in [0,180), S/V in [0,255].
# float32 arithmetic with round-half-to-even (torch.round, like jnp.round)
# reproduces cv2's fixed-point conversion exactly on the uint8 grid.

from __future__ import annotations

import torch


def rgb_to_hsv_u8(rgb: torch.Tensor) -> torch.Tensor:
    """[..., 3] uint8 RGB -> [..., 3] uint8 HSV (cv2.COLOR_RGB2HSV)."""
    rgb = rgb.to(torch.float32)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    v = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    diff = v - mn
    zero, one = torch.zeros_like(v), torch.ones_like(v)
    safe_v = torch.where(v == 0, one, v)
    safe_diff = torch.where(diff == 0, one, diff)
    s = torch.where(v == 0, zero, torch.round(255.0 * diff / safe_v))
    val = torch.where(
        v == r, g - b,
        torch.where(v == g, (b - r) + 2.0 * diff, (r - g) + 4.0 * diff))
    h = torch.where(diff == 0, zero, torch.round(30.0 * val / safe_diff))
    h = torch.where(h < 0, h + 180.0, h)
    h = torch.where(h >= 180, h - 180.0, h)
    return torch.stack([h, s, v], dim=-1).to(torch.uint8)


def hsv_to_rgb_u8(hsv: torch.Tensor) -> torch.Tensor:
    """[..., 3] uint8 HSV -> [..., 3] uint8 RGB (cv2.COLOR_HSV2RGB)."""
    hsv = hsv.to(torch.float32)
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    h = h * (2.0 / 60.0)              # [0,180) -> sector units [0,6)
    s = s * (1.0 / 255.0)
    sector = torch.floor(h)
    frac = h - sector
    tab = torch.stack([v, v * (1.0 - s), v * (1.0 - s * frac),
                       v * (1.0 - s * (1.0 - frac))], dim=-1)
    sector = torch.remainder(sector.to(torch.int64), 6)
    # (r, g, b) take these tab entries in sectors 0..5 (cv2's sector_data)
    table = torch.tensor([[0, 3, 1], [2, 0, 1], [1, 0, 3],
                          [1, 2, 0], [3, 1, 0], [0, 1, 2]],
                         device=hsv.device)
    rgb = torch.gather(tab, -1, table[sector])
    return torch.clamp(torch.round(rgb), 0, 255).to(torch.uint8)
