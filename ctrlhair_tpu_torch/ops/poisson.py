# Poisson image blending as a matrix-free conjugate-gradient solve.
#
# Port of ctrlhair_tpu/ops/poisson.py.  This module sets the system up and
# decodes its solution; method='cg' solves it with ops/poisson_pallas.
# masked_cg (the CUDA kernel on a card), method='mg' with the geometric
# multigrid below, in plain torch ops as the JAX twin is plain XLA.  The
# system:
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

from ctrlhair_tpu_torch.ops.resize import resize_bilinear


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


# --------------------------------------------------------------- multigrid
# Every level is [N, C, H, W]; `unk` is the level's unknown mask, broadcast
# over the channels.  Twin: ctrlhair_tpu/ops/poisson.py:58-134.

def _masked_laplacian(u: torch.Tensor, unk: torch.Tensor) -> torch.Tensor:
    """A_l u on one level: couplings only between unknowns."""
    return laplacian(u * unk) * unk


def _jacobi(u, b, unk, omega: float = 0.8, n: int = 2):
    for _ in range(n):
        r = (b - _masked_laplacian(u, unk)) * unk
        u = u + (omega / 4.0) * r
    return u


def _restrict(x: torch.Tensor) -> torch.Tensor:
    """2x2 mean."""
    n, c, h, w = x.shape
    return x.reshape(n, c, h // 2, 2, w // 2, 2).mean(dim=(3, 5))


def _prolong(x: torch.Tensor) -> torch.Tensor:
    """Cell-centred bilinear prolongation (half-pixel convention)."""
    h, w = x.shape[-2:]
    return resize_bilinear(x, (h * 2, w * 2), align_corners=False)


def _v_cycle(u, b, unks, level: int = 0):
    """Geometric multigrid V(2,2) with damped Jacobi smoothing; an
    80-iteration CG closes the coarsest (<= 16 px) level."""
    # imported here: poisson_pallas builds on this module's system set-up
    from ctrlhair_tpu_torch.ops.poisson_pallas import masked_cg_plain
    unk = unks[level]
    if level == len(unks) - 1 or u.shape[-2] <= 16:
        # the bottom solve must be (near-)exact or the global smooth mode
        # is never corrected; the plain CG is the JAX twin's _cg
        return masked_cg_plain(b, unk, u, 80)
    u = _jacobi(u, b, unk, n=2)
    r = (b - _masked_laplacian(u, unk)) * unk
    # Galerkin scaling: with piecewise-constant prolongation P and averaging
    # restriction R = P^T/4, R A_unit P = A_unit_coarse / 2
    rc = _restrict(r) * 2.0
    ec = _v_cycle(torch.zeros_like(rc), rc, unks, level + 1)
    u = (u + _prolong(ec)) * unk
    return _jacobi(u, b, unk, n=2)


def _build_unknown_pyramid(unk: torch.Tensor, min_size: int = 16):
    """[N,C,H,W] {0,1} unknown mask -> coarse pyramid (majority rule),
    stopping at <= min_size rows or when a side can no longer halve."""
    unks = [unk]
    while (unks[-1].shape[-2] > min_size
           and unks[-1].shape[-2] % 2 == 0 and unks[-1].shape[-1] % 2 == 0):
        unks.append((_restrict(unks[-1]) >= 0.5).to(torch.float32))
    return unks


def multigrid_solve(b_eff: torch.Tensor, unk: torch.Tensor,
                    x0: torch.Tensor, cycles: int = 10) -> torch.Tensor:
    """`cycles` V-cycles on the residual of the masked system from x0;
    [N,C,H,W] float32 with even H and W."""
    unks = _build_unknown_pyramid(unk)
    x = x0
    for _ in range(cycles):
        r = (b_eff - _masked_laplacian(x, unk)) * unk
        x = x + _v_cycle(torch.zeros_like(x), r, unks)
    return x


def poisson_blend(source: torch.Tensor, target: torch.Tensor,
                  mask: torch.Tensor, iterations: int = 300,
                  with_gamma: bool = True, method: str = 'cg',
                  mg_cycles: int = 10) -> torch.Tensor:
    """Blend `source` gradients into `target` inside `mask` (one image).

    source, target: [H, W, 3] in [0, 255]; mask: [H, W], mask!=0 receives
    source gradients.  Returns [H, W, 3] float32 in [0, 255].
    method 'cg': `iterations` CG steps through ops.poisson_pallas.
    masked_cg (the kernel on a card, its plain version on the CPU).
    method 'mg': `mg_cycles` multigrid V-cycles in plain torch ops; an odd
    H or W falls back to 'cg', as in the JAX twin.
    """
    from ctrlhair_tpu_torch.ops.poisson_pallas import poisson_blend_fused
    if method not in ('cg', 'mg'):
        raise ValueError(f'poisson_blend: unknown method {method!r}')
    h, w = source.shape[:2]
    if method == 'cg' or h % 2 or w % 2:
        return poisson_blend_fused(source[None], target[None], mask[None],
                                   iterations, with_gamma)[0]
    b_eff, unk, x0, fixed, tgt, gamma = blend_system(
        source[None], target[None], mask[None], with_gamma)
    x = multigrid_solve(b_eff, unk, x0, mg_cycles)
    return decode_solution(x, fixed, tgt, gamma)[0]
