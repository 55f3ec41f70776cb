# Batched Poisson blend around the fused masked-CG solve.
#
# Port of ctrlhair_tpu/ops/poisson_pallas.py (kept at the same relative
# path): the TPU kernel `pallas_masked_cg` becomes the hand-written CUDA
# kernel csrc/masked_cg.cu, one cooperative launch per blend, whose source
# note gives its bound and design.  `masked_cg` dispatches on where its
# tensors lie: on a CUDA device it launches the kernel (or raises); on the
# CPU it runs `masked_cg_plain`, the pure-torch statement of the same
# arithmetic and the kernel's reference.

from __future__ import annotations

import ctypes

import torch

from ctrlhair_tpu_torch.ops.poisson import (
    blend_system, decode_solution, laplacian)
from ctrlhair_tpu_torch.utils.cuda_build import CudaKernel


def _declare(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.masked_cg_grid.argtypes = [i32, ctypes.POINTER(i32)]
    lib.masked_cg_grid.restype = i32
    lib.masked_cg_launch.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, i32,
                                     i32, i32, i32, ptr]
    lib.masked_cg_launch.restype = i32
    lib.masked_cg_error_string.argtypes = [i32]
    lib.masked_cg_error_string.restype = ctypes.c_char_p


MASKED_CG = CudaKernel('masked_cg', _declare)


def _check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.masked_cg_error_string(err).decode()
        raise RuntimeError(f'masked_cg {what}: CUDA error {err} ({msg})')


def masked_cg_plain(b_eff: torch.Tensor, unk: torch.Tensor,
                    x0: torch.Tensor, iterations: int) -> torch.Tensor:
    """Pure-torch masked CG: [N,C,H,W] float32 b_eff, unk, x0 -> x.

    Fixed-count CG on A v = lap(v*unk)*unk, one solve per image: each
    image's dot products run over all its channels and pixels."""
    def a_op(v):
        return laplacian(v * unk) * unk

    def dot(a, b):
        return (a * b).sum(dim=(1, 2, 3), keepdim=True)

    x = x0
    r = (b_eff - a_op(x0)) * unk
    p = r
    rs = dot(r, r)
    for _ in range(iterations):
        ap = a_op(p)
        alpha = rs / (dot(p, ap) + 1e-20)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = dot(r, r)
        p = r + (rs_new / (rs + 1e-20)) * p
        rs = rs_new
    return x


def masked_cg_cuda(b_eff: torch.Tensor, unk: torch.Tensor, x0: torch.Tensor,
                   iterations: int) -> torch.Tensor:
    """One cooperative launch of csrc/masked_cg.cu on CUDA tensors."""
    ts = (b_eff, unk, x0)
    if any(t.device.type != 'cuda' or t.device != b_eff.device for t in ts):
        raise ValueError('masked_cg_cuda: b_eff, unk and x0 must lie on one '
                         'CUDA device')
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError('masked_cg_cuda: float32 tensors only')
    if b_eff.dim() != 4 or any(t.shape != b_eff.shape for t in ts):
        shapes = [tuple(t.shape) for t in ts]
        raise ValueError('masked_cg_cuda: b_eff, unk, x0 must share one '
                         f'[N,C,H,W] shape, got {shapes}')
    if not all(t.is_contiguous() for t in ts):
        raise ValueError('masked_cg_cuda: contiguous tensors only')
    n, c, h, w = b_eff.shape
    if n == 0 or iterations < 0 or n * c * h * w >= 2 ** 31:
        raise ValueError('masked_cg_cuda: unsupported size '
                         f'{tuple(b_eff.shape)} / iterations {iterations}')
    lib = MASKED_CG.lib()
    with torch.cuda.device(b_eff.device):
        grid = ctypes.c_int(0)
        _check(lib, lib.masked_cg_grid(n, ctypes.byref(grid)), 'grid query')
        x = torch.empty_like(b_eff)
        work = torch.empty(4 * b_eff.numel() + 2 * n * grid.value,
                           dtype=torch.float32, device=b_eff.device)
        stream = torch.cuda.current_stream(b_eff.device).cuda_stream
        err = lib.masked_cg_launch(
            b_eff.data_ptr(), unk.data_ptr(), x0.data_ptr(), x.data_ptr(),
            work.data_ptr(), n, c, h, w, iterations, grid.value, stream)
        _check(lib, err, 'launch')
    MASKED_CG.launches += 1
    return x


def masked_cg(b_eff: torch.Tensor, unk: torch.Tensor, x0: torch.Tensor,
              iterations: int = 200) -> torch.Tensor:
    """The fused CG solve: the kernel for CUDA tensors, the plain version
    for CPU tensors, an error for anything else."""
    if b_eff.device.type == 'cuda':
        return masked_cg_cuda(b_eff, unk, x0, iterations)
    if b_eff.device.type == 'cpu':
        return masked_cg_plain(b_eff, unk, x0, iterations)
    raise ValueError(f'masked_cg: no path for device {b_eff.device}')


def poisson_blend_fused(source: torch.Tensor, target: torch.Tensor,
                        mask: torch.Tensor, iterations: int = 200,
                        with_gamma: bool = True) -> torch.Tensor:
    """Batched Poisson blend with the fused CG core.

    source/target: [N,H,W,3] in [0,255]; mask: [N,H,W] (mask!=0 receives
    source gradients).  Same system as ops.poisson.poisson_blend.  Returns
    [N,H,W,3] float32 in [0,255].
    """
    b_eff, unk, x0, fixed, tgt, gamma = blend_system(source, target, mask,
                                                      with_gamma)
    x = masked_cg(b_eff, unk, x0, iterations)
    return decode_solution(x, fixed, tgt, gamma)
