# Triangle-mesh hair-mask warping: reference-photo shape transfer.
#
# Port of ctrlhair_tpu/ops/warp.py.  The reference chain is: write .node
# files -> subprocess Berkeley `triangle -q30` -> subprocess libigl `my_arap`
# (100 iters) -> parse OBJ -> Cython z-buffer rasterizer -> cv2.remap
# (ref: wrap_codes/wrap_triangle/triangle_wrap_hair.py:47-125,
# step_3/generate_node.py:23-93).  Here:
#   * the mesh build (a few hundred points) stays on the host: scipy Delaunay
#     over landmarks + boundary + interior Steiner grid points;
#   * deformation: ARAP solved by the native C++ module
#     (ctrlhair_tpu_torch/native/arap.cpp, same local-global algorithm as
#     libigl's, 100 iterations), or with use_arap=False a piecewise-affine
#     interpolation of the landmark displacements;
#   * rasterisation of the UV map, the bilinear gather, the threshold, the
#     crop, the composite and the downscale by one of three routes, chosen
#     by where the parsings lie (`hair_mask_transfer_warp(raster=None)`):
#       'kernel'  CUDA tensors: everything on the card, the UV map by the
#                 hand-written kernel csrc/raster_uv.cu (ops/raster_pallas);
#                 raises if the kernel cannot be built or launched;
#       'plain'   CPU tensors or numpy arrays: `_rasterize_composite` with
#                 `rasterize_uv`, the plain PyTorch version of the kernel;
#       'host'    only when asked for (`raster='host'`): native/raster.cpp,
#                 in double precision.  Nothing in the package asks for it:
#                 it is kept as a second, independent witness for the tests
#                 and for chip_smoke.py's comparison of the kernel route.
#     The first two are never named by a caller: the device decides.  No
#     environment variable selects a route and none gives way to another.

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ctrlhair_tpu_torch.constants import HAIR_IDX, UNKNOWN_LABEL

# landmark subset used for warping: all 81 minus brow endpoints
# (ref: wrap_codes/mask_adaptor.py:110)
CHOSEN_LANDMARKS = [k for k in range(81) if k not in (26, 17, 25, 19)]
BG_PAD = 80          # border padding in px (ref: mask_adaptor.py:120)
BOUNDARY_POINTS = 50  # boundary samples per side (ref: triangle_wrap_hair.py:53)
MAX_TRIS = 2048       # triangle budget of one warp mesh


def boundary_nodes(width: int, height: int,
                   num: int = BOUNDARY_POINTS) -> np.ndarray:
    """Boundary control points, fixed in place during deformation
    (ref: step_3/generate_node.py:37-71: top, bottom, then side interiors)."""
    xs = np.linspace(0, width - 1, num)
    ys = np.linspace(0, height - 1, num)
    top = np.stack([xs, np.zeros(num)], 1)
    bottom = np.stack([xs, np.full(num, height - 1)], 1)
    left = np.stack([np.zeros(num - 2), ys[1:-1]], 1)
    right = np.stack([np.full(num - 2, width - 1), ys[1:-1]], 1)
    return np.concatenate([top, bottom, left, right]).astype(np.float64)


def _steiner_points(existing: np.ndarray, width: int, height: int,
                    spacing: float) -> np.ndarray:
    """Interior grid points not too close to existing ones — a cheap,
    robust stand-in for `triangle -q30` Steiner refinement: they give ARAP
    free vertices so the deformation bends smoothly between landmarks."""
    xs = np.arange(spacing, width - 1 - spacing / 2, spacing)
    ys = np.arange(spacing, height - 1 - spacing / 2, spacing)
    gx, gy = np.meshgrid(xs, ys)
    grid = np.stack([gx.ravel(), gy.ravel()], 1)
    if len(existing):
        d2 = ((grid[:, None, :] - existing[None, :, :]) ** 2).sum(-1)
        grid = grid[d2.min(1) > (spacing * 0.5) ** 2]
    return grid


def build_warp_mesh(src_landmarks: np.ndarray, dst_landmarks: np.ndarray,
                    width: int, height: int, use_arap: bool = True):
    """Triangulate source points and deform them onto target landmarks.

    Returns (verts_src [V,2], verts_dst [V,2], tris [T,3]).
    Constrained vertices: landmarks -> dst positions, boundary -> identity
    (exactly the reference's correspondence file, generate_node.py:48-71);
    Steiner vertices are free: solved by the native ARAP (which raises if
    its library cannot be built), or with use_arap=False interpolated
    piecewise-affinely.
    """
    from scipy.spatial import Delaunay

    boundary = boundary_nodes(width, height)
    constrained_src = np.concatenate([src_landmarks, boundary])
    constrained_dst = np.concatenate([dst_landmarks, boundary])
    spacing = max(width, height) / 24.0
    steiner = _steiner_points(constrained_src, width, height, spacing)
    verts_src = np.concatenate([constrained_src, steiner])
    tri = Delaunay(verts_src)
    tris = tri.simplices.astype(np.int32)

    n_c = len(constrained_src)
    verts_dst = verts_src.copy()
    verts_dst[:n_c] = constrained_dst

    free_idx = np.arange(n_c, len(verts_src))
    if len(free_idx):
        if use_arap:
            from ctrlhair_tpu_torch.native import arap_solve
            verts_dst = arap_solve(verts_src, tris,
                                   np.arange(n_c), constrained_dst)
        else:
            verts_dst[free_idx] = piecewise_affine_free_verts(
                verts_src[free_idx], constrained_src, constrained_dst)
    return verts_src, verts_dst, tris


def piecewise_affine_free_verts(free_pts: np.ndarray,
                                constrained_src: np.ndarray,
                                constrained_dst: np.ndarray) -> np.ndarray:
    """Interpolate the constrained displacement field onto free points via
    the coarse constrained Delaunay: the non-ARAP piecewise-affine
    deformation.  build_warp_mesh's use_arap=False route, and an
    ARAP-independent cross-check of warp fidelity (the reference pipes the
    same correspondences through libigl ARAP instead,
    ref: wrap_codes/wrap_triangle/triangle_wrap_hair.py:47-125)."""
    from scipy.spatial import Delaunay

    disp = constrained_dst - constrained_src
    coarse = Delaunay(constrained_src)
    simplex = coarse.find_simplex(free_pts)
    simplex = np.maximum(simplex, 0)
    trans = coarse.transform[simplex]
    bary2 = np.einsum('nij,nj->ni', trans[:, :2], free_pts - trans[:, 2])
    bary = np.concatenate([bary2, 1 - bary2.sum(1, keepdims=True)], 1)
    tri_pts = coarse.simplices[simplex]
    return free_pts + np.einsum('ni,nid->nd', bary, disp[tri_pts])


def rasterize_uv(verts_dst: torch.Tensor, tris: torch.Tensor,
                 uv: torch.Tensor, height: int, width: int,
                 chunk: int = 16) -> torch.Tensor:
    """Rasterize per-vertex UVs of the deformed mesh into a [H, W, 2] map:
    the plain version of the kernel csrc/raster_uv.cu.

    verts_dst: [V,2] float32 pixel coords; tris: [T,3] int (rows whose first
    index is negative are padding); uv: [V,2] float32; all on one device.
    Edge-function tests over chunks of triangles in list order: the first
    triangle whose three orientation-normalised edge functions are all
    >= -1e-6 gives the pixel its barycentric UV.  Pixels covered by no
    triangle keep the identity mapping (px/W, py/H) (the reference instead
    leaves -1 and patches borders, triangle_wrap_hair.py:78-85).
    """
    dev = verts_dst.device
    ys = torch.arange(height, dtype=torch.float32, device=dev)
    xs = torch.arange(width, dtype=torch.float32, device=dev)
    py, px = torch.meshgrid(ys, xs, indexing='ij')
    px, py = px.reshape(-1, 1), py.reshape(-1, 1)          # [P,1]
    uv_flat = torch.cat([px / width, py / height], 1)      # identity UV
    found = torch.zeros(px.shape[0], dtype=torch.bool, device=dev)
    tris = tris[tris[:, 0] >= 0].long()
    eps = -1e-6

    for start in range(0, tris.shape[0], chunk):
        idx = tris[start:start + chunk]
        a, b, c = (verts_dst[idx[:, k]] for k in range(3))  # [C,2]
        area = ((b[:, 0] - a[:, 0]) * (c[:, 1] - a[:, 1])
                - (b[:, 1] - a[:, 1]) * (c[:, 0] - a[:, 0]))  # [C]
        s = torch.where(area >= 0, 1.0, -1.0)
        inv_area = s / torch.clamp(torch.abs(area), min=1e-12)

        def edge(p0, p1):
            # cross(p1-p0, p-p0) for all pixels: [P,C]
            return ((p1[:, 0] - p0[:, 0]) * (py - p0[:, 1])
                    - (p1[:, 1] - p0[:, 1]) * (px - p0[:, 0]))

        w_a = edge(b, c) * s                                # [P,C] ~ alpha
        w_b = edge(c, a) * s
        w_c = edge(a, b) * s
        inside = (w_a >= eps) & (w_b >= eps) & (w_c >= eps)
        hit = inside.any(dim=1)                             # [P]
        # the first triangle of the chunk that holds the pixel
        first = inside.to(torch.uint8).argmax(dim=1)        # [P]
        pick = lambda w: w.gather(1, first[:, None])[:, 0] * inv_area[first]
        alpha, beta, gamma = pick(w_a), pick(w_b), pick(w_c)
        tri_first = idx[first]                              # [P,3]
        uv_hit = (alpha[:, None] * uv[tri_first[:, 0]]
                  + beta[:, None] * uv[tri_first[:, 1]]
                  + gamma[:, None] * uv[tri_first[:, 2]])   # [P,2]
        new = hit & ~found
        uv_flat = torch.where(new[:, None], uv_hit, uv_flat)
        found = found | hit
    return uv_flat.reshape(height, width, 2)


def sample_uv(img: torch.Tensor, uv_map: torch.Tensor) -> torch.Tensor:
    """Bilinear gather img[v*H, u*W] (cv2.remap semantics incl. x=u*W scale,
    ref: step_4/get_pixelValue.py:34-48).  img: [H,W]; uv_map: [h,w,2]."""
    h_src, w_src = img.shape
    x = uv_map[..., 0] * w_src
    y = uv_map[..., 1] * h_src
    x0 = torch.clamp(torch.floor(x), 0, w_src - 1).long()
    y0 = torch.clamp(torch.floor(y), 0, h_src - 1).long()
    x1 = torch.clamp(x0 + 1, 0, w_src - 1)
    y1 = torch.clamp(y0 + 1, 0, h_src - 1)
    fx = torch.clamp(x - x0, 0.0, 1.0)
    fy = torch.clamp(y - y0, 0.0, 1.0)
    imgf = img.to(torch.float32)
    v00 = imgf[y0, x0]
    v01 = imgf[y0, x1]
    v10 = imgf[y1, x0]
    v11 = imgf[y1, x1]
    out = (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
           + v10 * (1 - fx) * fy + v11 * fx * fy)
    oob = (x < 0) | (x > w_src - 1) | (y < 0) | (y > h_src - 1)
    return torch.where(oob, torch.zeros_like(out), out)


def naive_transfer(hair_parsing: np.ndarray,
                   target_parsing: np.ndarray) -> np.ndarray:
    """Overlay warped hair onto target parsing; uncovered old hair -> 255
    (ref: wrap_codes/mask_adaptor.py:63-73)."""
    out = np.asarray(target_parsing).astype(np.int32).copy()
    out[out == HAIR_IDX] = UNKNOWN_LABEL
    out[np.asarray(hair_parsing) == HAIR_IDX] = HAIR_IDX
    return out


def _pad_smear_np(hair_parsing: np.ndarray, pad: int) -> np.ndarray:
    """Host twin of _pad_smear (ref: mask_adaptor.py:119-131)."""
    size = hair_parsing.shape[0]
    hair = (hair_parsing == HAIR_IDX).astype(np.float32)
    total = np.zeros((size + 2 * pad, size + 2 * pad), np.float32)
    total[pad:size + pad, pad:size + pad] = hair
    total[pad - 10:pad, :][:, total[pad, :] == 1] = 1
    total[-pad:-pad + 10, :][:, total[-1 - pad, :] == 1] = 1
    total[total[:, pad] == 1, pad - 10:pad] = 1
    total[total[:, -1 - pad] == 1, -pad:-pad + 10] = 1
    return total


def _pad_smear(hair_parsing: torch.Tensor, pad: int) -> torch.Tensor:
    """Pad the hair mask by `pad` and smear border-touching hair 10px
    outward (ref: mask_adaptor.py:119-131), on the parsing's device."""
    s = hair_parsing.shape[0]
    big = s + 2 * pad
    total = torch.zeros((big, big), dtype=torch.float32,
                        device=hair_parsing.device)
    total[pad:pad + s, pad:pad + s] = (hair_parsing == HAIR_IDX).float()

    def smear(strip, edge):
        """In place: strip := 1 where the border line `edge` is hair."""
        strip.copy_(torch.where(edge == 1, torch.ones_like(strip), strip))

    # in this order: the side smears see the rows the top and bottom made
    smear(total[pad - 10:pad, :], total[pad][None, :])
    smear(total[big - pad:big - pad + 10, :],
          total[big - 1 - pad][None, :])
    smear(total[:, pad - 10:pad], total[:, pad][:, None])
    smear(total[:, big - pad:big - pad + 10],
          total[:, big - 1 - pad][:, None])
    return total


def _composite_uv(uv_map: torch.Tensor, hair_parsing: torch.Tensor,
                  face_parsing: torch.Tensor, size: int, pad: int,
                  out_size: int = 0) -> torch.Tensor:
    """UV map [size,size,2] -> composite parsing: sample the padded and
    smeared hair mask, threshold, crop, overlay, downscale."""
    total = _pad_smear(hair_parsing, pad)
    # truncation semantics: only fully-interior pixels (value 1.0) count,
    # matching the reference's astype-uint8 of the sampled float mask
    # (>0.5 would grow the contour by ~1px)
    warped = sample_uv(total, uv_map) >= 1.0 - 1e-6
    warped = warped[pad:size - pad, pad:size - pad]
    # naive_transfer (ref: mask_adaptor.py:63-73): uncovered old hair -> 255
    face = face_parsing.to(torch.int32)
    out = torch.where(face == HAIR_IDX, torch.full_like(face, UNKNOWN_LABEL),
                      face)
    out = torch.where(warped, torch.full_like(out, HAIR_IDX), out)
    work = size - 2 * pad
    if out_size and out_size != work and work % out_size == 0:
        # the edit-size nearest downscale (cv2.INTER_NEAREST strided fast
        # path; the reference chain resizes after the warp, ui/backend.py:277)
        f = work // out_size
        out = out[::f, ::f]
    return out.contiguous()


def _rasterize_composite(verts_dst: torch.Tensor, tris: torch.Tensor,
                         uv: torch.Tensor, hair_parsing: torch.Tensor,
                         face_parsing: torch.Tensor, size: int, pad: int,
                         out_size: int = 0) -> torch.Tensor:
    """The 'plain' route: the plain rasteriser, then the composite."""
    uv_map = rasterize_uv(verts_dst, tris, uv, size, size)
    return _composite_uv(uv_map, hair_parsing, face_parsing, size, pad,
                         out_size)


def _resolve_route(raster: Optional[str], device: torch.device) -> str:
    if raster == 'host':
        return 'host'
    if raster is not None:
        raise ValueError(f"raster must be None or 'host', got {raster!r}")
    if device.type == 'cuda':
        return 'kernel'
    if device.type == 'cpu':
        return 'plain'
    raise ValueError(f'hair_mask_transfer_warp: no route for {device}')


def hair_mask_transfer_warp(hair_parsing, face_parsing,
                            hair_lm_81: np.ndarray,
                            face_lm_81: np.ndarray,
                            use_arap: bool = True,
                            out_size: int = 0,
                            raster: Optional[str] = None):
    """Warp the donor's hair mask onto the target face geometry
    (ref: wrap_codes/mask_adaptor.py:87-143).

    hair_lm_81 / face_lm_81: [81,2] in [0,1].  Parsings: [S,S] labels (512
    on the main path), both numpy arrays or both tensors on one device.
    raster=None takes the kernel route for CUDA tensors and the plain one
    for CPU tensors and numpy arrays; raster='host' asks for
    native/raster.cpp, the reference witness (see the module note).
    Returns the composite parsing (255 where old hair is uncovered) at the
    working size, or nearest-downscaled to `out_size` when given: an int32
    tensor on the parsings' device, or a numpy array for numpy parsings.
    """
    from_numpy = not isinstance(hair_parsing, torch.Tensor)
    if from_numpy != (not isinstance(face_parsing, torch.Tensor)):
        raise TypeError('hair_mask_transfer_warp: both parsings must be '
                        'numpy arrays or both tensors')
    if from_numpy:
        hair_parsing = torch.from_numpy(np.ascontiguousarray(hair_parsing))
        face_parsing = torch.from_numpy(np.ascontiguousarray(face_parsing))
    device = hair_parsing.device
    if face_parsing.device != device:
        raise ValueError('hair_mask_transfer_warp: parsings lie on '
                         f'{device} and {face_parsing.device}')
    if hair_parsing.dim() != 2 or hair_parsing.shape != face_parsing.shape \
            or hair_parsing.shape[0] != hair_parsing.shape[1]:
        raise ValueError('hair_mask_transfer_warp: two square [S,S] '
                         f'parsings expected, got {tuple(hair_parsing.shape)}'
                         f' and {tuple(face_parsing.shape)}')
    route = _resolve_route(raster, device)

    size = hair_parsing.shape[0]
    hair_lm = np.asarray(hair_lm_81, np.float64) * size
    face_lm = np.asarray(face_lm_81, np.float64) * size

    sel = CHOSEN_LANDMARKS
    pad = BG_PAD
    big = size + 2 * pad
    verts_src, verts_dst, tris = build_warp_mesh(
        hair_lm[sel] + pad, face_lm[sel] + pad, big, big, use_arap=use_arap)
    if tris.shape[0] > MAX_TRIS:
        raise RuntimeError(f'triangle budget exceeded: {tris.shape[0]}')
    # UV normalisation is verts/size with sampling at u*size — an exact
    # round trip for the identity warp (matches the reference convention:
    # my_arap texture coords + textureSampling, get_pixelValue.py:34-35)
    uv = verts_src / big

    if route == 'host':
        from ctrlhair_tpu_torch import native
        out = torch.from_numpy(native.rasterize_warp_composite(
            verts_dst, tris, uv,
            _pad_smear_np(hair_parsing.cpu().numpy(), pad),
            face_parsing.cpu().numpy(), pad, HAIR_IDX, UNKNOWN_LABEL,
            out_size)).to(device)
    elif route == 'kernel':
        from ctrlhair_tpu_torch.ops.raster_pallas import rasterize_uv_cuda
        # only the mesh and its bin tables are uploaded; the parsings are
        # on the card already and the composite stays there
        uv_map = rasterize_uv_cuda(verts_dst, tris, uv, big, big, device)
        out = _composite_uv(uv_map, hair_parsing, face_parsing, big, pad,
                            out_size)
    else:
        up = lambda a, dt: torch.as_tensor(a, dtype=dt, device=device)
        out = _rasterize_composite(
            up(verts_dst, torch.float32), up(tris, torch.int64),
            up(uv, torch.float32), hair_parsing, face_parsing, big, pad,
            out_size)
    return out.numpy() if from_numpy else out


def warp_for_image_with_idx(catalog, landmark_dict, hair_key: str,
                            face_key: str, use_arap: bool = True,
                            device=None) -> torch.Tensor:
    """Catalogue-driven warp for preprocessed datasets (ref:
    wrap_codes/mask_adaptor.py:146-172): both label maps read from the
    catalogue, resized by nearest to 512 and put on `device` (None: the
    first CUDA device, where the warp takes the kernel route), landmarks
    from the precomputed landmark81 dict.  Returns the composite parsing,
    an int32 [512,512] tensor on `device`."""
    from ctrlhair_tpu_torch.ops.resize import resize_nearest
    from ctrlhair_tpu_torch.pipeline.editor import resolve_device
    from ctrlhair_tpu_torch.utils.image import read_png

    device = resolve_device(device)

    def parsing(key):
        label = read_png(catalog.label_path(key)).astype(np.int32)
        return resize_nearest(torch.from_numpy(label), (512, 512)).to(device)

    return hair_mask_transfer_warp(
        parsing(hair_key), parsing(face_key),
        np.asarray(landmark_dict[hair_key]),
        np.asarray(landmark_dict[face_key]), use_arap=use_arap)


def _crop_for_warp(img: np.ndarray, editor, crop_size: int) -> np.ndarray:
    """FFHQ-align one raw photo at `crop_size` before shape transfer
    (ref: wrap_codes/mask_adaptor.py:186-200 crops BOTH images at 1024).
    The landmarks come from ops.landmarks' 'auto' estimator on the editor's
    device: the learned net on the photo, else the contour of its parse."""
    from ctrlhair_tpu_torch.ops.crop import recreate_aligned_image
    from ctrlhair_tpu_torch.ops.landmarks import estimate_landmarks_68

    label512 = editor.parse(img[None])[0].cpu().numpy()
    lm68 = estimate_landmarks_68(label512, image=img, device=editor.device)
    lm68_px = lm68 * np.array([img.shape[1], img.shape[0]], np.float64)
    out, _ = recreate_aligned_image(img, lm68_px, crop_size)
    return out


def warp_hair_mask_between_images(hair_img, face_img, editor,
                                  use_arap: bool = True,
                                  need_crop: bool = True,
                                  crop_size: int = 1024,
                                  hair_parse512=None, face_parse512=None,
                                  hair_lm81: Optional[np.ndarray] = None,
                                  face_lm81: Optional[np.ndarray] = None):
    """End-to-end reference-shape transfer between two photos
    (ref: wrap_codes/mask_adaptor.py:175-220): FFHQ-align both photos at
    `crop_size` (need_crop, skippable for aligned inputs), parse both crops
    in one batch, estimate 81 landmarks of each, warp, and return the
    composite parsing at the editor's edit size, on the editor's device.

    hair_parse512/face_parse512/hair_lm81/face_lm81: optional precomputed
    parses ([P,P] tensors on the editor's device) and [81,2] landmarks of
    aligned inputs: the Backend already parsed both images at
    set_input/set_target time, so repeated transfers skip the parser and the
    landmark estimation (the reference instead re-runs dlib + BiSeNet per
    transfer, ref: mask_adaptor.py:202-212).  A crop invalidates them.
    """
    from ctrlhair_tpu_torch.ops.landmarks import estimate_landmarks_81

    if need_crop:
        hair_img = _crop_for_warp(np.asarray(hair_img), editor, crop_size)
        face_img = _crop_for_warp(np.asarray(face_img), editor, crop_size)
        hair_parse512 = face_parse512 = None
        hair_lm81 = face_lm81 = None

    hair_np, face_np = np.asarray(hair_img), np.asarray(face_img)
    if hair_parse512 is None or face_parse512 is None:
        if hair_np.shape == face_np.shape:
            # one batched parse for both images
            hair512, face512 = editor.parse(np.stack([hair_np, face_np]))
        else:
            hair512 = editor.parse(hair_np[None])[0]
            face512 = editor.parse(face_np[None])[0]
    else:
        hair512 = editor._as(hair_parse512, torch.int32)
        face512 = editor._as(face_parse512, torch.int32)
    hair_lm = (estimate_landmarks_81(hair512.cpu().numpy(), image=hair_np,
                                     device=editor.device)
               if hair_lm81 is None else np.asarray(hair_lm81))
    face_lm = (estimate_landmarks_81(face512.cpu().numpy(), image=face_np,
                                     device=editor.device)
               if face_lm81 is None else np.asarray(face_lm81))
    return hair_mask_transfer_warp(hair512, face512, hair_lm, face_lm,
                                   use_arap=use_arap,
                                   out_size=editor.cfg.edit_size)
