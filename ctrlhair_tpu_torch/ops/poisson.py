# Poisson image blending as a matrix-free conjugate-gradient solve.
#
# Port of ctrlhair_tpu/ops/poisson.py, method='cg' (the multigrid method is
# not ported yet).  This module sets the system up and decodes its
# solution; the CG solve itself is ops/poisson_pallas.masked_cg.  The system:
#   * rows: interior pixels with mask==0 are Dirichlet (f = target); all other
#     pixels (mask!=0, plus the whole image border) carry the 5-point
#     Laplacian 4f - sum(neighbours), neighbours outside the image being 0;
#   * rhs: Laplacian of the source where mask!=0, target where mask==0;
#   * gamma 2.2 encode/decode around the solve.
# The unknown set gives a symmetric positive-definite reduced system, so CG
# converges.  The stencil is built from pads and slices, never conv2d, so
# no TF32 path can touch it.

from __future__ import annotations

import torch
import torch.nn.functional as F


def laplacian(x: torch.Tensor) -> torch.Tensor:
    """4x - (up + down + left + right) over the trailing [H, W] dims, zero
    outside the image (horizontal couplings never wrap across rows)."""
    h, w = x.shape[-2], x.shape[-1]
    p = F.pad(x, (1, 1, 1, 1))
    y = 4.0 * x
    y = y - p[..., 0:h, 1:w + 1]        # up neighbour
    y = y - p[..., 2:h + 2, 1:w + 1]    # down
    y = y - p[..., 1:h + 1, 0:w]        # left
    y = y - p[..., 1:h + 1, 2:w + 2]    # right
    return y


def _laplacian_full(x: torch.Tensor) -> torch.Tensor:
    """The JAX twin's [H, W, C] signature of `laplacian`."""
    return laplacian(x.movedim(-1, -3)).movedim(-3, -1)


def blend_system(source: torch.Tensor, target: torch.Tensor,
                 mask: torch.Tensor, with_gamma: bool = True):
    """Set up the masked system for a batch.

    source, target: [N, H, W, 3] in [0, 255]; mask: [N, H, W].
    Returns (b_eff, unk, x0, fixed, tgt, gamma): b_eff, unk and x0 are
    [N, 3, H, W] float32 (unk broadcast over channels); fixed [N, 1, H, W]
    bool and tgt [N, 3, H, W] are what the solution is decoded with.
    """
    gamma = 2.2 if with_gamma else 1.0
    chw = lambda t: t.to(torch.float32).permute(0, 3, 1, 2)
    src = torch.pow(torch.clamp(chw(source), min=0.0), 1.0 / gamma)
    tgt = torch.pow(torch.clamp(chw(target), min=0.0), 1.0 / gamma)
    n, _, h, w = src.shape
    m = (mask != 0)[:, None]
    interior = torch.zeros((h, w), dtype=torch.bool, device=src.device)
    interior[1:h - 1, 1:w - 1] = True
    fixed = ~m & interior
    unk = (~fixed).to(torch.float32)
    b = torch.where(m, laplacian(src), tgt)
    x_fixed = torch.where(fixed, tgt, torch.zeros_like(tgt))
    b_eff = (b - laplacian(x_fixed)) * unk
    unk3 = unk.expand(-1, src.shape[1], -1, -1).contiguous()
    # start from the source: the solution is the source plus a harmonic ring
    # correction, so this start converges ~10x faster than the target
    x0 = (src * unk).contiguous()
    return b_eff.contiguous(), unk3, x0, fixed, tgt, gamma


def decode_solution(x: torch.Tensor, fixed: torch.Tensor, tgt: torch.Tensor,
                    gamma: float) -> torch.Tensor:
    """[N,3,H,W] solution -> [N,H,W,3] in [0,255]: Dirichlet pixels take the
    target, then the gamma decode and the clip."""
    out = torch.where(fixed, tgt, x)
    out = torch.pow(torch.clamp(out, min=0.0), gamma)
    return torch.clamp(out, 0.0, 255.0).permute(0, 2, 3, 1)


def poisson_blend(source: torch.Tensor, target: torch.Tensor,
                  mask: torch.Tensor, iterations: int = 300,
                  with_gamma: bool = True, method: str = 'cg'
                  ) -> torch.Tensor:
    """Blend `source` gradients into `target` inside `mask` (one image).

    source, target: [H, W, 3] in [0, 255]; mask: [H, W], mask!=0 receives
    source gradients.  Returns [H, W, 3] float32 in [0, 255].  The CG
    solve is ops.poisson_pallas.masked_cg: the kernel on a card, its plain
    version on the CPU.
    """
    # imported here: poisson_pallas builds on this module's system set-up
    from ctrlhair_tpu_torch.ops.poisson_pallas import poisson_blend_fused
    if method != 'cg':
        raise NotImplementedError(f'poisson_blend method {method!r}')
    return poisson_blend_fused(source[None], target[None], mask[None],
                               iterations, with_gamma)[0]
