# Batched Poisson blend around the fused masked-CG solve.
#
# Port of ctrlhair_tpu/ops/poisson_pallas.py (kept at the same relative
# path): the TPU kernel `pallas_masked_cg` becomes the hand-written CUDA
# source csrc/masked_cg.cu, one launch per blend, whose source note gives
# its bound and design.  `masked_cg` dispatches on where its tensors lie: on
# a CUDA device it launches a kernel (or raises); on the CPU it runs
# `masked_cg_plain`, the pure-torch statement of the same arithmetic and the
# kernels' reference.  On the card the shape alone picks between the
# source's two kernels (`cluster_plan`): one image per thread-block cluster
# with the CG state in shared memory where a cluster can hold the image,
# else one cooperative launch over the whole card with the state in global
# memory.

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

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
    lib.masked_cg_cluster_layout.argtypes = [ctypes.POINTER(i32)] * 4
    lib.masked_cg_cluster_layout.restype = None
    lib.masked_cg_cluster_active.argtypes = [i32, ctypes.POINTER(i32)]
    lib.masked_cg_cluster_active.restype = i32
    lib.masked_cg_cluster_launch.argtypes = [ptr] * 4 + [i32] * 9 + [ptr]
    lib.masked_cg_cluster_launch.restype = i32
    lib.masked_cg_barrier_probe.argtypes = [i32, i32, ptr]
    lib.masked_cg_barrier_probe.restype = i32
    lib.masked_cg_error_string.argtypes = [i32]
    lib.masked_cg_error_string.restype = ctypes.c_char_p
    layout = [i32(0) for _ in range(4)]
    lib.masked_cg_cluster_layout(*(ctypes.byref(v) for v in layout))
    mine = (CLUSTER_SIZE, BAND_ROWS, CLUSTER_THREADS, CLUSTER_SMEM_BYTES)
    if tuple(v.value for v in layout) != mine:
        raise RuntimeError('masked_cg: the cluster kernel is laid out as '
                           f'{[v.value for v in layout]}, the plan as {mine}')


MASKED_CG = CudaKernel('masked_cg', _declare)
# launches of each of the source's two kernels; their sum is
# MASKED_CG.launches
ROUTE_LAUNCHES = {'cluster': 0, 'grid': 0}

# The cluster kernel as csrc/masked_cg.cu lays it out (held against the
# library's own constants when it is loaded).
CLUSTER_SIZE = 16              # blocks of a cluster
BAND_ROWS = 16                 # the most rows a block's band may have
CLUSTER_THREADS = 768          # a block's threads, one per column of [C, W]
BLOCK_SMEM_LIMIT = 232448      # dynamic shared memory a block may ask for
# a block's shared memory: r, p, ap and unk (float32) of a band laid out at
# its most rows and threads whatever the shape, 32 floats for its warps'
# sums and two arrays of one float per block of the cluster
CLUSTER_SMEM_BYTES = 4 * (4 * BAND_ROWS * CLUSTER_THREADS
                          + 32 + 2 * CLUSTER_SIZE)


class ClusterPlan(NamedTuple):
    """How one [C,H,W] image is split over a cluster of CLUSTER_SIZE
    blocks: block k owns rows bands[k][0]:bands[k][1] of every channel."""
    shape: Tuple[int, int, int]         # (C, H, W)
    rows: int                           # rows of a full band
    bands: Tuple[Tuple[int, int], ...]  # one (start, stop) per block
    working: int                        # blocks that own at least one row
    threads: int                        # threads of a block
    smem_bytes: int                     # dynamic shared memory of a block


@functools.lru_cache(maxsize=None)
def cluster_plan(c: int, h: int, w: int) -> Optional[ClusterPlan]:
    """The cluster kernel's split of a [C,H,W] image, or None when a
    cluster cannot hold it.

    Rows go to the blocks in bands of ceil(H / CLUSTER_SIZE): the last
    working band is ragged when H is no multiple, and blocks beyond
    H / rows own nothing (they only pass the barriers).  A thread owns one
    column of one channel.  A block's shared memory is CLUSTER_SMEM_BYTES
    whatever the shape.  None when C*W exceeds a block's threads or a band
    has more rows than the kernel unrolls."""
    if min(c, h, w) < 1 or c * w > CLUSTER_THREADS:
        return None
    rows = -(-h // CLUSTER_SIZE)
    if rows > BAND_ROWS:
        return None
    threads = -(-c * w // 32) * 32
    bands = tuple((min(k * rows, h), min((k + 1) * rows, h))
                  for k in range(CLUSTER_SIZE))
    return ClusterPlan((c, h, w), rows, bands, -(-h // rows), threads,
                       CLUSTER_SMEM_BYTES)


def masked_cg_route(c: int, h: int, w: int) -> str:
    """Which kernel `masked_cg_cuda` launches for [N,C,H,W] tensors:
    'cluster' when `cluster_plan(c, h, w)` holds the image, else 'grid'.  A
    rule of the shape alone."""
    return 'cluster' if cluster_plan(c, h, w) is not None else 'grid'


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


@functools.lru_cache(maxsize=None)
def active_clusters(device_index: int, threads: int) -> int:
    """Clusters of blocks of `threads` threads the card can run at once.
    The first call for a device also sets the kernel's shared memory and
    cluster size there; the answer is kept.  Raises when the card can run
    none."""
    lib = MASKED_CG.lib()
    active = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        _check(lib, lib.masked_cg_cluster_active(
            threads, ctypes.byref(active)), 'cluster query')
    if active.value < 1:
        raise RuntimeError(
            f'masked_cg: the card runs no cluster of {CLUSTER_SIZE} blocks '
            f'with {CLUSTER_SMEM_BYTES} B of shared memory each')
    return active.value


@functools.lru_cache(maxsize=None)
def _grid_blocks(device_index: int, n: int) -> int:
    """The largest co-resident grid of the cooperative kernel for N images
    (asked once per device and N, then kept)."""
    lib = MASKED_CG.lib()
    grid = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        _check(lib, lib.masked_cg_grid(n, ctypes.byref(grid)), 'grid query')
    return grid.value


def _checked(b_eff: torch.Tensor, unk: torch.Tensor, x0: torch.Tensor,
             iterations: int) -> int:
    """Raise on what the kernels do not take; return the device's index."""
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
    if b_eff.shape[0] == 0 or iterations < 0 or b_eff.numel() >= 2 ** 31:
        raise ValueError('masked_cg_cuda: unsupported size '
                         f'{tuple(b_eff.shape)} / iterations {iterations}')
    index = b_eff.device.index
    return torch.cuda.current_device() if index is None else index


def masked_cg_cluster_cuda(b_eff: torch.Tensor, unk: torch.Tensor,
                           x0: torch.Tensor, iterations: int) -> torch.Tensor:
    """One launch of the cluster kernel on CUDA tensors: min(N, active
    clusters) clusters, each taking image after image.  Raises for a shape
    `cluster_plan` does not hold."""
    return _cluster_launch(_checked(b_eff, unk, x0, iterations), b_eff, unk,
                           x0, iterations)


def _cluster_launch(index: int, b_eff, unk, x0,
                    iterations: int) -> torch.Tensor:
    n, c, h, w = b_eff.shape
    plan = cluster_plan(c, h, w)
    if plan is None:
        raise ValueError(f'masked_cg_cluster_cuda: a cluster of '
                         f'{CLUSTER_SIZE} blocks cannot hold [{c},{h},{w}]')
    lib = MASKED_CG.lib()
    clusters = min(n, active_clusters(index, plan.threads))
    with torch.cuda.device(index):
        x = torch.empty_like(b_eff)
        stream = torch.cuda.current_stream(b_eff.device).cuda_stream
        err = lib.masked_cg_cluster_launch(
            b_eff.data_ptr(), unk.data_ptr(), x0.data_ptr(), x.data_ptr(),
            n, c, h, w, iterations, clusters, plan.rows, plan.working,
            plan.threads, stream)
        _check(lib, err, 'cluster launch')
    MASKED_CG.count_launch()
    ROUTE_LAUNCHES['cluster'] += 1
    return x


def masked_cg_grid_cuda(b_eff: torch.Tensor, unk: torch.Tensor,
                        x0: torch.Tensor, iterations: int) -> torch.Tensor:
    """One cooperative launch of the grid kernel on CUDA tensors of any
    [N,C,H,W] shape, the CG state in a scratch buffer in global memory."""
    return _grid_launch(_checked(b_eff, unk, x0, iterations), b_eff, unk, x0,
                        iterations)


def _grid_launch(index: int, b_eff, unk, x0, iterations: int) -> torch.Tensor:
    n, c, h, w = b_eff.shape
    lib = MASKED_CG.lib()
    grid = _grid_blocks(index, n)
    with torch.cuda.device(index):
        x = torch.empty_like(b_eff)
        work = torch.empty(4 * b_eff.numel() + 2 * n * grid,
                           dtype=torch.float32, device=b_eff.device)
        stream = torch.cuda.current_stream(b_eff.device).cuda_stream
        err = lib.masked_cg_launch(
            b_eff.data_ptr(), unk.data_ptr(), x0.data_ptr(), x.data_ptr(),
            work.data_ptr(), n, c, h, w, iterations, grid, stream)
        _check(lib, err, 'grid launch')
    MASKED_CG.count_launch()
    ROUTE_LAUNCHES['grid'] += 1
    return x


def masked_cg_cuda(b_eff: torch.Tensor, unk: torch.Tensor, x0: torch.Tensor,
                   iterations: int) -> torch.Tensor:
    """One launch of csrc/masked_cg.cu on CUDA tensors.

    The kernel is `masked_cg_route(C, H, W)`: the cluster kernel for every
    shape a cluster holds (`cluster_plan`), the cooperative grid kernel for
    the rest.  A rule of the shape alone: a launch that is refused raises,
    and neither kernel gives way to the other."""
    index = _checked(b_eff, unk, x0, iterations)
    if masked_cg_route(*b_eff.shape[1:]) == 'cluster':
        return _cluster_launch(index, b_eff, unk, x0, iterations)
    return _grid_launch(index, b_eff, unk, x0, iterations)


def barrier_probe_cuda(threads: int, count: int, device) -> None:
    """Launch one cluster of CLUSTER_SIZE blocks of `threads` threads that
    passes `count` cluster barriers and does nothing else: timed, it is the
    least a solve's chain of 2 x iterations reductions can take."""
    lib = MASKED_CG.lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        _check(lib, lib.masked_cg_barrier_probe(threads, count, stream),
               'barrier probe')


def masked_cg(b_eff: torch.Tensor, unk: torch.Tensor, x0: torch.Tensor,
              iterations: int = 200) -> torch.Tensor:
    """The fused CG solve: a kernel for CUDA tensors (`masked_cg_route`
    says which), the plain version for CPU tensors, an error for anything
    else."""
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
