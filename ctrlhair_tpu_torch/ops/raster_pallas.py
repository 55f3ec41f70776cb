# The tiled UV rasteriser of the warp mesh (kernel K2) and its host binning.
#
# Port of ctrlhair_tpu/ops/raster_pallas.py (kept at the same relative
# path): the TPU kernel `_kernel`, launched by `_rasterize_binned`, becomes
# the hand-written CUDA kernel csrc/raster_uv.cu, one launch per UV map,
# whose source note gives its design.  The triangles are binned per pixel
# tile on the host (the mesh is built there anyway) into one packed index
# array with an offset per tile, so a tile walks only the triangles whose
# bounding box meets it, in ascending triangle index:
# "first hit wins" then names the same triangle as in the plain version,
# ops/warp.rasterize_uv, which walks the whole list in order.
# `rasterize_uv_cuda` launches the kernel on CUDA tensors or raises; there
# is no CPU form of it: on the CPU ops/warp takes the plain version.

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from ctrlhair_tpu_torch.utils.cuda_build import CudaKernel

# the pixel tile of one block (csrc/raster_uv.cu: RASTER_TILE_H/W)
TILE_H = 16
TILE_W = 32
MAX_BIN = 256          # triangle budget per tile; doubles up to 4x


def _declare(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.raster_uv_launch.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32,
                                     i32, i32, ptr]
    lib.raster_uv_launch.restype = i32
    lib.raster_uv_tile.argtypes = [ctypes.POINTER(i32), ctypes.POINTER(i32)]
    lib.raster_uv_tile.restype = None
    lib.raster_uv_resident_blocks.argtypes = [ctypes.POINTER(i32)]
    lib.raster_uv_resident_blocks.restype = i32
    lib.raster_uv_empty_launch.argtypes = [ptr]
    lib.raster_uv_empty_launch.restype = i32
    lib.raster_uv_error_string.argtypes = [i32]
    lib.raster_uv_error_string.restype = ctypes.c_char_p
    th, tw = i32(0), i32(0)
    lib.raster_uv_tile(ctypes.byref(th), ctypes.byref(tw))
    if (th.value, tw.value) != (TILE_H, TILE_W):
        raise RuntimeError(f'raster_uv: the kernel tiles {th.value}x'
                           f'{tw.value} pixels, the binning {TILE_H}x{TILE_W}')


# -fmad=false: an FMA in an edge function would round once where the plain
# version rounds twice and could hand an edge pixel to the other triangle
RASTER_UV = CudaKernel('raster_uv', _declare, extra_flags=('-fmad=false',))


def triangle_tables(verts_dst: np.ndarray, tris: np.ndarray,
                    uv: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-triangle vertices and UVs, padding rows of `tris` (first index
    negative) dropped: (tri [T,8] float32 = ax ay bx by cx cy 0 0,
    uvt [T,8] float32 = ua va ub vb uc vc 0 0).  The binning reads `tri`;
    `triangle_rows` makes the kernel's rows of both."""
    verts = np.asarray(verts_dst, np.float32)
    uvf = np.asarray(uv, np.float32)
    tris = np.asarray(tris)
    tris = tris[tris[:, 0] >= 0]
    if tris.size and (tris.min() < 0 or tris.max() >= len(verts)):
        raise ValueError('triangle_tables: vertex index out of range')
    zeros = np.zeros((len(tris), 2), np.float32)
    tri = np.concatenate([verts[tris[:, 0]], verts[tris[:, 1]],
                          verts[tris[:, 2]], zeros], 1)
    uvt = np.concatenate([uvf[tris[:, 0]], uvf[tris[:, 1]],
                          uvf[tris[:, 2]], zeros], 1)
    return tri, uvt


def triangle_rows(tri: np.ndarray, uvt: np.ndarray) -> np.ndarray:
    """The kernel's 64-byte row per triangle, [T,16] float32:
    ax ay bx by | cx cy s inv_area | ua va ub vb | uc vc 0 0.

    The orientation sign s and the reciprocal area are computed here once
    per mesh, in float32 with the operations of ops/warp.rasterize_uv in
    its order (numpy rounds after every operation and fuses nothing), so
    the kernel's values equal the plain version's bit for bit."""
    tri = np.asarray(tri, np.float32)
    ax, ay, bx, by, cx, cy = (tri[:, k] for k in range(6))
    area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
    s = np.where(area >= 0, np.float32(1.0), np.float32(-1.0))
    inv_area = s / np.maximum(np.abs(area), np.float32(1e-12))
    rows = np.zeros((len(tri), 16), np.float32)
    rows[:, 0:6] = tri[:, 0:6]
    rows[:, 6] = s
    rows[:, 7] = inv_area
    rows[:, 8:14] = np.asarray(uvt, np.float32)[:, 0:6]
    return rows


def bin_triangles(tri: np.ndarray, height: int, width: int,
                  max_bin: int = MAX_BIN
                  ) -> Tuple[np.ndarray, np.ndarray, int, int]:
    """Host tile binning of `triangle_tables`' rows, packed.

    Every triangle goes to every tile its bounding box meets (tile ranges
    clipped to the grid, as the JAX binning clips them).  Returns
    (offsets [G+1] int32, indices [offsets[G]] int32, grid_h, grid_w) with
    G = grid_h*grid_w row-major tiles: tile g's triangle indices are
    indices[offsets[g]:offsets[g+1]], ascending.  Raises OverflowError when
    a tile meets more than `max_bin` triangles."""
    grid_h = -(-height // TILE_H)
    grid_w = -(-width // TILE_W)
    n_tiles = grid_h * grid_w
    xs, ys = tri[:, 0:6:2], tri[:, 1:6:2]
    ty0 = np.clip((ys.min(1) // TILE_H).astype(np.int64), 0, grid_h - 1)
    ty1 = np.clip((ys.max(1) // TILE_H).astype(np.int64), 0, grid_h - 1)
    tx0 = np.clip((xs.min(1) // TILE_W).astype(np.int64), 0, grid_w - 1)
    tx1 = np.clip((xs.max(1) // TILE_W).astype(np.int64), 0, grid_w - 1)
    nx = tx1 - tx0 + 1
    per_tri = (ty1 - ty0 + 1) * nx
    # one (triangle, tile) pair per covered tile, triangles ascending
    t_idx = np.repeat(np.arange(len(tri)), per_tri)
    k = np.arange(per_tri.sum()) - np.repeat(np.cumsum(per_tri) - per_tri,
                                             per_tri)
    tile = ((ty0[t_idx] + k // nx[t_idx]) * grid_w
            + tx0[t_idx] + k % nx[t_idx])
    counts = np.bincount(tile, minlength=n_tiles)
    if counts.max(initial=0) > max_bin:
        raise OverflowError('per-tile triangle budget exceeded')
    # a stable sort by tile keeps the triangles of a tile ascending
    order = np.argsort(tile, kind='stable')
    offsets = np.zeros(n_tiles + 1, np.int32)
    np.cumsum(counts, out=offsets[1:])
    return offsets, t_idx[order].astype(np.int32), grid_h, grid_w


def bin_with_retry(tri: np.ndarray, height: int, width: int):
    """`bin_triangles` with the budget doubled on overflow, up to 4x
    MAX_BIN; then the OverflowError stands.  Returns bin_triangles' tuple
    plus the budget used."""
    max_bin = MAX_BIN
    while True:
        try:
            return bin_triangles(tri, height, width, max_bin) + (max_bin,)
        except OverflowError:
            if max_bin >= 4 * MAX_BIN:
                raise
            max_bin *= 2


def _check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.raster_uv_error_string(err).decode()
        raise RuntimeError(f'raster_uv {what}: CUDA error {err} ({msg})')


def resident_blocks(device) -> int:
    """Blocks of the kernel the card holds at once (a map of no more tiles
    runs in one wave)."""
    lib = RASTER_UV.lib()
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device):
        _check(lib, lib.raster_uv_resident_blocks(ctypes.byref(blocks)),
               'occupancy query')
    return blocks.value


def empty_launch_cuda(device) -> None:
    """Launch an empty kernel: timed, it is what any launch takes, the
    yardstick of a kernel whose bound lies below it."""
    lib = RASTER_UV.lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        _check(lib, lib.raster_uv_empty_launch(stream), 'empty launch')


def rasterize_binned_cuda(rows: torch.Tensor, offsets: torch.Tensor,
                          indices: torch.Tensor, height: int,
                          width: int) -> torch.Tensor:
    """One launch of csrc/raster_uv.cu on CUDA tensors -> [H,W,2] float32.
    rows [T,16] float32 (`triangle_rows`), offsets [G+1] and indices int32
    (`bin_triangles`)."""
    ts = (rows, offsets, indices)
    if any(t.device.type != 'cuda' or t.device != rows.device for t in ts):
        raise ValueError('rasterize_binned_cuda: all tables must lie on one '
                         'CUDA device')
    if rows.dtype != torch.float32 or offsets.dtype != torch.int32 \
            or indices.dtype != torch.int32:
        raise TypeError('rasterize_binned_cuda: float32 triangle rows and '
                        'int32 offsets and indices only')
    grid_h = -(-height // TILE_H)
    grid_w = -(-width // TILE_W)
    if rows.dim() != 2 or rows.shape[1] != 16 or indices.dim() != 1 \
            or offsets.shape != (grid_h * grid_w + 1,):
        shapes = [tuple(t.shape) for t in ts]
        raise ValueError(f'rasterize_binned_cuda: {height}x{width} needs '
                         f'[T,16] rows and {grid_h * grid_w} tiles, got '
                         f'{shapes}')
    if not all(t.is_contiguous() for t in ts) or rows.data_ptr() % 16:
        raise ValueError('rasterize_binned_cuda: contiguous tensors and '
                         '16-byte aligned rows only')
    if height < 1 or width < 1 or height * width >= 2 ** 30:
        raise ValueError(f'rasterize_binned_cuda: unsupported size '
                         f'{height}x{width}')
    lib = RASTER_UV.lib()
    with torch.cuda.device(rows.device):
        out = torch.empty((height, width, 2), dtype=torch.float32,
                          device=rows.device)
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        err = lib.raster_uv_launch(
            rows.data_ptr(), offsets.data_ptr(), indices.data_ptr(),
            out.data_ptr(), rows.shape[0], indices.shape[0], height, width,
            grid_h, grid_w, stream)
        _check(lib, err, 'launch')
    RASTER_UV.count_launch()
    return out


def pack_tables(rows: np.ndarray, offsets: np.ndarray,
                indices: np.ndarray) -> np.ndarray:
    """The three tables as one array of 32-bit words, rows first (so that
    they stay 16-byte aligned), for one upload per mesh."""
    return np.concatenate([rows.ravel().view(np.int32), offsets, indices])


def unpack_tables(words: torch.Tensor, n_tris: int, n_tiles: int):
    """Views of `pack_tables`' words, on whatever device they lie:
    (rows [T,16] float32, offsets [G+1] int32, indices int32)."""
    r = 16 * n_tris
    return (words[:r].view(torch.float32).view(n_tris, 16),
            words[r:r + n_tiles + 1], words[r + n_tiles + 1:])


def rasterize_uv_cuda(verts_dst, tris, uv, height: int, width: int,
                      device) -> torch.Tensor:
    """The counterpart of `rasterize_uv_pallas`: bin the mesh on the host,
    upload the tables (one array, one copy), launch the kernel.  verts_dst
    [V,2] px, tris [T,3] int (rows with a negative first index are padding),
    uv [V,2]; numpy arrays or CPU tensors.  Returns the [H,W,2] UV map on
    `device`, which must be a CUDA device."""
    device = torch.device(device)
    if device.type != 'cuda':
        raise ValueError(f'rasterize_uv_cuda: {device} is not a CUDA device; '
                         'on the CPU use ops.warp.rasterize_uv')
    tri, uvt = triangle_tables(np.asarray(verts_dst), np.asarray(tris),
                               np.asarray(uv))
    offsets, indices, grid_h, grid_w, _ = bin_with_retry(tri, height, width)
    words = torch.from_numpy(
        pack_tables(triangle_rows(tri, uvt), offsets, indices)).to(device)
    return rasterize_binned_cuda(
        *unpack_tables(words, len(tri), grid_h * grid_w), height, width)
