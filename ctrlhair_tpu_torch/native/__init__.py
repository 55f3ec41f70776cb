# Native (C++) host components, loaded in-process via ctypes.
#
# Port of ctrlhair_tpu/native/__init__.py with its own copies of arap.cpp and
# raster.cpp.  The shared library is built at first use from these sources
# by utils/cuda_build.HostLibrary (the host compiler, into
# ctrlhair_tpu_torch/_build/).  Unlike the JAX loader, which returns None
# when the build or the load fails so that its callers quietly take another
# route, a failed build, load or call here raises.

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from ctrlhair_tpu_torch.utils.cuda_build import HostLibrary

_DIR = Path(__file__).resolve().parent


def _declare(lib: ctypes.CDLL) -> None:
    f64p = ctypes.POINTER(ctypes.c_double)
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int)
    i32 = ctypes.c_int
    lib.arap_solve_2d.restype = i32
    lib.arap_solve_2d.argtypes = [f64p, i32, i32p, i32, i32p, i32, f64p, i32,
                                  f64p]
    lib.rasterize_warp_composite.restype = i32
    lib.rasterize_warp_composite.argtypes = [
        f64p, i32, i32p, i32, f64p, f32p, i32, i32p, i32, i32, i32, i32, i32,
        i32p]


NATIVE = HostLibrary('ctrlhair_native',
                     [_DIR / 'arap.cpp', _DIR / 'raster.cpp'], _declare)


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def rasterize_warp_composite(verts_dst: np.ndarray, tris: np.ndarray,
                             uv: np.ndarray, total: np.ndarray,
                             face_parsing: np.ndarray, pad: int,
                             hair_idx: int, unknown_label: int,
                             out_size: int = 0) -> np.ndarray:
    """Host rasterize + sample + composite for one warp (see raster.cpp).

    verts_dst, uv: [V,2]; tris: [T,3] (rows with a negative index are
    skipped); total: [big,big] padded hair mask; face_parsing: [size,size]
    with big == size + 2*pad.  Returns the composite parsing, decimated to
    `out_size` when that divides `size`.
    """
    v = np.ascontiguousarray(verts_dst, np.float64)
    t = np.ascontiguousarray(tris, np.int32)
    u = np.ascontiguousarray(uv, np.float64)
    tot = np.ascontiguousarray(total, np.float32)
    face = np.ascontiguousarray(face_parsing, np.int32)
    big, size = tot.shape[0], face.shape[0]
    if tot.shape != (big, big) or face.shape != (size, size) \
            or big != size + 2 * pad:
        raise ValueError(f'rasterize_warp_composite: total {tot.shape} is '
                         f'not face {face.shape} padded by {pad}')
    if v.ndim != 2 or v.shape[1] != 2 or u.shape != v.shape \
            or t.ndim != 2 or t.shape[1] != 3:
        raise ValueError('rasterize_warp_composite: verts/uv must be [V,2] '
                         f'and tris [T,3], got {v.shape} {u.shape} {t.shape}')
    # the one place the output grid is chosen; C validates divisibility
    # and writes exactly [out_n, out_n]
    out_n = (out_size if out_size and out_size != size
             and size % out_size == 0 else size)
    out = np.empty((out_n, out_n), np.int32)
    ret = NATIVE.lib().rasterize_warp_composite(
        _ptr(v, ctypes.c_double), len(v), _ptr(t, ctypes.c_int), len(t),
        _ptr(u, ctypes.c_double), _ptr(tot, ctypes.c_float), big,
        _ptr(face, ctypes.c_int), size, int(pad), int(hair_idx),
        int(unknown_label), int(out_n), _ptr(out, ctypes.c_int))
    if ret != 0:
        raise RuntimeError(f'rasterize_warp_composite failed (code {ret})')
    return out


def arap_solve(verts: np.ndarray, tris: np.ndarray,
               constrained_idx: np.ndarray, constrained_pos: np.ndarray,
               iterations: int = 100) -> np.ndarray:
    """2-D ARAP deformation; returns the deformed [V,2] vertices.

    iterations=100 matches the reference (my_arap.cpp:183).
    """
    v = np.ascontiguousarray(verts, np.float64)
    t = np.ascontiguousarray(tris, np.int32)
    ci = np.ascontiguousarray(constrained_idx, np.int32)
    cp = np.ascontiguousarray(constrained_pos, np.float64)
    if v.ndim != 2 or v.shape[1] != 2 or t.ndim != 2 or t.shape[1] != 3 \
            or cp.shape != (len(ci), 2):
        # the C side reads constrained_pos[2*c..] for every index: a shape
        # mismatch would be an out-of-bounds native read
        raise ValueError('arap_solve: verts [V,2], tris [T,3], constrained '
                         f'[C] / [C,2] expected, got {v.shape} {t.shape} '
                         f'{ci.shape} {cp.shape}')
    if len(t) and (t.min() < 0 or t.max() >= len(v)):
        raise ValueError('arap_solve: triangle index out of range')
    out = np.empty_like(v)
    ret = NATIVE.lib().arap_solve_2d(
        _ptr(v, ctypes.c_double), len(v), _ptr(t, ctypes.c_int), len(t),
        _ptr(ci, ctypes.c_int), len(ci), _ptr(cp, ctypes.c_double),
        int(iterations), _ptr(out, ctypes.c_double))
    if ret != 0:
        raise RuntimeError(f'arap_solve failed (code {ret})')
    return out
