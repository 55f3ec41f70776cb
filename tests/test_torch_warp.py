# The port's shape-transfer path against the JAX package's: the host mesh
# and ARAP, the plain rasteriser (the reference of the CUDA kernel
# csrc/raster_uv.cu), the bilinear gather, the padding, the host binning the
# kernel reads, and the whole warp by its CPU routes.
#
# Tolerances.  Mesh: the same numpy/scipy code and the same C++, verts
# within 1e-9, triangles equal.  UV maps: float32 on both sides, but XLA may
# contract or reorder the edge functions, so a pixel on a shared edge can go
# to the neighbouring triangle: >= 99.5% of pixels within 1e-4 and a median
# difference < 1e-6 (the bar of tests/test_raster_pallas.py); the identity
# UV is exact.  sample_uv: atol 1e-5.  Composites are label maps: >= 99.9%
# equal between the float32 routes, >= 99.99% between the two builds of the
# same C++.
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ctrlhair_tpu.constants import HAIR_IDX, UNKNOWN_LABEL
from ctrlhair_tpu.ops import warp as jw
from ctrlhair_tpu.ops.landmarks import canonical_template_81
from ctrlhair_tpu.ops.raster_pallas import rasterize_uv_pallas
from ctrlhair_tpu_torch import native
from ctrlhair_tpu_torch.ops import raster_pallas as rp
from ctrlhair_tpu_torch.ops import warp as tw


def five_point_mesh(size, shift, use_arap=False, mod=tw):
    """The mesh of tests/test_raster_pallas.py."""
    src = np.array([[16, 16], [size - 16, 16], [16, size - 16],
                    [size - 16, size - 16], [size / 2, size / 2]], float)
    return mod.build_warp_mesh(src, src + np.asarray(shift), size, size,
                               use_arap=use_arap)


def uv_stats(got, ref):
    d = np.abs(np.asarray(got) - np.asarray(ref))
    return (d < 1e-4).mean(), float(np.median(d)), (d == 0).mean()


# ------------------------------------------------------------------- mesh
def test_boundary_and_steiner_points_equal():
    for w, h in ((64, 64), (672, 672), (300, 200)):
        np.testing.assert_array_equal(tw.boundary_nodes(w, h),
                                      jw.boundary_nodes(w, h))
    existing = np.random.default_rng(0).uniform(0, 672, (80, 2))
    for ex in (existing, np.zeros((0, 2))):
        np.testing.assert_array_equal(
            tw._steiner_points(ex, 672, 672, 28.0),
            jw._steiner_points(ex, 672, 672, 28.0))
    assert tw.CHOSEN_LANDMARKS == jw.CHOSEN_LANDMARKS
    assert (tw.BG_PAD, tw.MAX_TRIS) == (jw.BG_PAD, jw.MAX_TRIS)


@pytest.mark.parametrize('use_arap', [False, True])
def test_build_warp_mesh_equal(use_arap):
    lm = canonical_template_81().astype(np.float64)
    sel = tw.CHOSEN_LANDMARKS
    src = lm[sel] * 512 + 80
    dst = (lm[sel] * [0.9, 0.95] + [0.06, 0.01]) * 512 + 80
    got = tw.build_warp_mesh(src, dst, 672, 672, use_arap=use_arap)
    ref = jw.build_warp_mesh(src, dst, 672, 672, use_arap=use_arap)
    np.testing.assert_allclose(got[0], ref[0], atol=1e-9)
    np.testing.assert_allclose(got[1], ref[1], atol=1e-9)
    np.testing.assert_array_equal(got[2], ref[2])
    assert 1000 < len(got[2]) <= tw.MAX_TRIS
    # the constraints hold, and the free vertices moved
    n_c = len(sel) + len(tw.boundary_nodes(672, 672))
    np.testing.assert_allclose(got[1][:len(sel)], dst, atol=1e-9)
    np.testing.assert_array_equal(got[1][len(sel):n_c], got[0][len(sel):n_c])
    assert np.abs(got[1][n_c:] - got[0][n_c:]).max() > 1.0


def _square_mesh():
    verts = np.array([[0, 0], [10, 0], [0, 10], [10, 10], [5, 5]], float)
    tris = np.array([[0, 1, 4], [1, 3, 4], [3, 2, 4], [2, 0, 4]], np.int32)
    return verts, tris


@pytest.mark.parametrize('case', ['identity', 'translation', 'rotation'])
def test_arap_rigid_motions(case):
    """The bars of tests/test_warp.py on the port's own build of arap.cpp."""
    verts, tris = _square_mesh()
    if case == 'identity':
        target, atol = verts, 1e-6
    elif case == 'translation':
        target, atol = verts + np.array([3.0, -2.0]), 1e-4
    else:
        rot = np.array([[np.cos(0.3), -np.sin(0.3)],
                        [np.sin(0.3), np.cos(0.3)]])
        target, atol = (verts - 5) @ rot.T + 5, 1e-3
    out = native.arap_solve(verts, tris, np.arange(4), target[:4])
    np.testing.assert_allclose(out, target, atol=atol)


def test_native_rejects_bad_shapes():
    verts, tris = _square_mesh()
    with pytest.raises(ValueError):
        native.arap_solve(verts, tris, np.arange(4), verts[:3])
    with pytest.raises(ValueError):
        native.arap_solve(verts, tris + 3, np.arange(4), verts[:4])
    with pytest.raises(ValueError):
        native.rasterize_warp_composite(
            verts, tris, verts / 10, np.zeros((12, 12), np.float32),
            np.zeros((10, 10), np.int32), 2, HAIR_IDX, UNKNOWN_LABEL)


# ------------------------------------------------------------- rasteriser
@pytest.mark.parametrize('use_arap', [False, True])
def test_rasterize_uv_matches_jax_and_pallas(use_arap):
    size = 64
    verts, dst, tris = five_point_mesh(size, (3.0, -2.0), use_arap)
    pad = np.full((jw.MAX_TRIS, 3), -1, np.int32)
    pad[:len(tris)] = tris
    uv = (verts / size).astype(np.float32)
    jargs = (jnp.asarray(dst, jnp.float32), jnp.asarray(pad),
             jnp.asarray(uv), size, size)
    got = tw.rasterize_uv(torch.tensor(dst, dtype=torch.float32),
                          torch.tensor(pad), torch.tensor(uv), size, size)
    assert got.shape == (size, size, 2) and got.dtype == torch.float32
    for name, ref in (('xla', jw.rasterize_uv(*jargs)),
                      ('pallas', rasterize_uv_pallas(*jargs,
                                                     interpret=True))):
        within, median, exact = uv_stats(got, ref)
        print(f'{name}: within 1e-4 {within:.5f}, median {median:.2e}, '
              f'bit-equal {exact:.5f}')
        assert within >= 0.995 and median < 1e-6, (name, within, median)
    # unpadded triangles and another chunk size give the same map
    again = tw.rasterize_uv(torch.tensor(dst, dtype=torch.float32),
                            torch.tensor(tris), torch.tensor(uv), size, size,
                            chunk=7)
    torch.testing.assert_close(again, got, rtol=0, atol=0)


def test_rasterize_uv_first_triangle_wins():
    """Two triangles over the same pixels: the earlier one gives the UV."""
    verts = torch.tensor([[0., 0.], [20., 0.], [0., 20.], [20., 20.]])
    uv = torch.tensor([[0., 0.], [1., 0.], [0., 1.], [.5, .5]])
    both = torch.tensor([[0, 1, 2], [1, 3, 2], [0, 1, 3]])
    out = tw.rasterize_uv(verts, both, uv, 16, 16)
    only_first = tw.rasterize_uv(verts, both[:1], uv, 16, 16)
    ys, xs = torch.meshgrid(torch.arange(16), torch.arange(16),
                            indexing='ij')
    inside_first = xs + ys <= 20
    assert inside_first.sum() < 256      # the others cover the rest
    torch.testing.assert_close(out[inside_first], only_first[inside_first],
                               rtol=0, atol=0)
    assert (out[2, 3] - torch.tensor([3 / 20, 2 / 20])).abs().max() < 1e-6


def _rasterize_uv_dense(verts_dst, tris, uv, height, width, chunk=16):
    """ops.warp.rasterize_uv as it was before it tested only the pixels no
    earlier triangle holds: every pixel against every chunk, the first hit
    kept by a mask.  The plain version's yardstick for the rewrite."""
    dev = verts_dst.device
    ys = torch.arange(height, dtype=torch.float32, device=dev)
    xs = torch.arange(width, dtype=torch.float32, device=dev)
    py, px = torch.meshgrid(ys, xs, indexing='ij')
    px, py = px.reshape(-1, 1), py.reshape(-1, 1)
    uv_flat = torch.cat([px / width, py / height], 1)
    found = torch.zeros(px.shape[0], dtype=torch.bool, device=dev)
    tris = tris[tris[:, 0] >= 0].long()
    eps = -1e-6
    for start in range(0, tris.shape[0], chunk):
        idx = tris[start:start + chunk]
        a, b, c = (verts_dst[idx[:, k]] for k in range(3))
        area = ((b[:, 0] - a[:, 0]) * (c[:, 1] - a[:, 1])
                - (b[:, 1] - a[:, 1]) * (c[:, 0] - a[:, 0]))
        s = torch.where(area >= 0, 1.0, -1.0)
        inv_area = s / torch.clamp(torch.abs(area), min=1e-12)

        def edge(p0, p1):
            return ((p1[:, 0] - p0[:, 0]) * (py - p0[:, 1])
                    - (p1[:, 1] - p0[:, 1]) * (px - p0[:, 0]))

        w_a = edge(b, c) * s
        w_b = edge(c, a) * s
        w_c = edge(a, b) * s
        inside = (w_a >= eps) & (w_b >= eps) & (w_c >= eps)
        hit = inside.any(dim=1)
        first = inside.to(torch.uint8).argmax(dim=1)
        pick = lambda w: w.gather(1, first[:, None])[:, 0] * inv_area[first]
        alpha, beta, gamma = pick(w_a), pick(w_b), pick(w_c)
        tri_first = idx[first]
        uv_hit = (alpha[:, None] * uv[tri_first[:, 0]]
                  + beta[:, None] * uv[tri_first[:, 1]]
                  + gamma[:, None] * uv[tri_first[:, 2]])
        new = hit & ~found
        uv_flat = torch.where(new[:, None], uv_hit, uv_flat)
        found = found | hit
    return uv_flat.reshape(height, width, 2)


@pytest.mark.parametrize('chunk', [16, 7])
@pytest.mark.parametrize('seed', [0, 1, 2])
def test_rasterize_uv_equals_dense_version(seed, chunk):
    """The plain rasteriser, which tests only the pixels still open, equals
    the dense version bit for bit: random meshes whose triangles overlap,
    reach past the border, repeat a vertex or lie on a line, with padding
    rows between them, at chunk sizes that do and do not divide the list.
    Seed 2 covers the whole image early, so the loop stops before the
    list's end."""
    rng = np.random.default_rng(seed)
    h, w, nv = 40, 48, 30
    verts = rng.uniform(-6, 54, (nv, 2)).astype(np.float32)
    verts[-3:] = [[5, 5], [15, 15], [25, 25]]          # collinear
    tris = rng.integers(0, nv, (57, 3)).astype(np.int32)
    tris[5] = [2, 2, 7]                                # a repeated vertex
    tris[11] = [nv - 3, nv - 2, nv - 1]                # zero area
    tris[[3, 20, 33]] = -1                             # padding
    if seed == 2:
        verts[:3] = [[-100, -100], [300, -100], [-100, 300]]
        tris[9] = [0, 1, 2]                            # covers every pixel
    uv = rng.uniform(0, 1, (nv, 2)).astype(np.float32)
    args = (torch.tensor(verts), torch.tensor(tris), torch.tensor(uv), h, w,
            chunk)
    got, ref = tw.rasterize_uv(*args), _rasterize_uv_dense(*args)
    dense_identity = torch.stack(torch.meshgrid(
        torch.arange(w) / w, torch.arange(h) / h, indexing='xy'), -1)
    assert (ref != dense_identity).any(-1).float().mean() > 0.3
    np.testing.assert_array_equal(got.numpy(), ref.numpy())


def test_rasterize_uv_identity_fallback_exact():
    size = 32
    pad = torch.full((64, 3), -1, dtype=torch.int32)
    out = tw.rasterize_uv(torch.zeros(3, 2), pad, torch.zeros(3, 2), size,
                          size)
    xs = (np.arange(size, dtype=np.float32) / np.float32(size))
    np.testing.assert_array_equal(out[:, :, 0].numpy(),
                                  np.broadcast_to(xs[None, :], (size, size)))
    np.testing.assert_array_equal(out[:, :, 1].numpy(),
                                  np.broadcast_to(xs[:, None], (size, size)))
    ref = rasterize_uv_pallas(jnp.zeros((3, 2)), jnp.asarray(pad.numpy()),
                              jnp.zeros((3, 2)), size, size, interpret=True)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    # an odd size: px / W in float32, still equal to numpy's division
    odd = tw.rasterize_uv(torch.zeros(3, 2), pad, torch.zeros(3, 2), 5, 7)
    np.testing.assert_array_equal(
        odd[0, :, 0].numpy(), np.arange(7, dtype=np.float32) / np.float32(7))


def test_sample_uv_matches_jax(rng):
    img = rng.uniform(0, 1, (48, 40)).astype(np.float32)
    uv = rng.uniform(-0.1, 1.1, (30, 36, 2)).astype(np.float32)
    got = tw.sample_uv(torch.tensor(img), torch.tensor(uv))
    ref = jw.sample_uv(jnp.asarray(img), jnp.asarray(uv))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    assert (got.numpy() == 0).any()          # some samples fell outside


def test_pad_smear_and_naive_transfer_exact(rng):
    hair = np.zeros((64, 64), np.int32)
    hair[0:20, 10:30] = HAIR_IDX        # touches the top
    hair[30:64, 0:8] = HAIR_IDX         # touches the left and the bottom
    hair[50:64, 56:64] = HAIR_IDX       # the bottom-right corner
    hair[25:28, 40:44] = 3              # another label
    ref = np.asarray(jw._pad_smear(jnp.asarray(hair), 16))
    np.testing.assert_array_equal(tw._pad_smear(torch.tensor(hair),
                                                16).numpy(), ref)
    np.testing.assert_array_equal(tw._pad_smear_np(hair, 16),
                                  jw._pad_smear_np(hair, 16))
    target = rng.integers(0, 19, (64, 64)).astype(np.int32)
    np.testing.assert_array_equal(tw.naive_transfer(hair, target),
                                  jw.naive_transfer(hair, target))


# ---------------------------------------------------------------- binning
def brute_force_bins(tri, height, width):
    """Every triangle whose bounding box meets a tile, by the JAX binning's
    rule (float floor-division, ranges clipped to the grid)."""
    gh, gw = -(-height // rp.TILE_H), -(-width // rp.TILE_W)
    want = [[] for _ in range(gh * gw)]
    for t, row in enumerate(tri):
        xs, ys = row[0:6:2], row[1:6:2]
        y0, y1 = (int(np.clip(v // rp.TILE_H, 0, gh - 1))
                  for v in (ys.min(), ys.max()))
        x0, x1 = (int(np.clip(v // rp.TILE_W, 0, gw - 1))
                  for v in (xs.min(), xs.max()))
        for gy in range(y0, y1 + 1):
            for gx in range(x0, x1 + 1):
                want[gy * gw + gx].append(t)
    return want


@pytest.mark.parametrize('size,shift', [(64, (3.0, -2.0)),
                                        (100, (-7.5, 40.0))])
def test_binning_invariants(size, shift):
    verts, dst, tris = five_point_mesh(size, shift)
    pad = np.full((len(tris) + 9, 3), -1, np.int32)
    pad[:len(tris)] = tris
    tri, uvt = rp.triangle_tables(dst, pad, verts / size)
    assert tri.shape == uvt.shape == (len(tris), 8)
    assert tri.dtype == uvt.dtype == np.float32
    np.testing.assert_array_equal(tri[:, 2:4],
                                  dst[tris[:, 1]].astype(np.float32))
    offsets, indices, gh, gw = rp.bin_triangles(tri, size, size)
    want = brute_force_bins(tri, size, size)
    assert offsets.shape == (gh * gw + 1,) and offsets.dtype == np.int32
    assert indices.dtype == np.int32 and offsets[0] == 0
    assert offsets[-1] == len(indices) == sum(map(len, want))
    assert np.diff(offsets).max() <= rp.MAX_BIN
    for g, lst in enumerate(want):
        # all of the tile's triangles, ascending, and nothing else
        assert indices[offsets[g]:offsets[g + 1]].tolist() == lst
    # the kernel's rows: the vertices, the sign and the reciprocal area of
    # the plain version, the UVs, two zeros
    rows = rp.triangle_rows(tri, uvt)
    assert rows.shape == (len(tris), 16) and rows.dtype == np.float32
    np.testing.assert_array_equal(rows[:, 0:6], tri[:, 0:6])
    np.testing.assert_array_equal(rows[:, 8:14], uvt[:, 0:6])
    assert (rows[:, 14:] == 0).all() and (np.abs(rows[:, 6]) == 1).all()


def test_binning_overflow_doubles_then_raises(monkeypatch):
    # 300 copies of one triangle in a single tile: over 256, under 512
    one = np.array([[2, 2, 12, 2, 2, 12, 0, 0]], np.float32)
    offsets, indices, _, _, used = rp.bin_with_retry(np.repeat(one, 300, 0),
                                                     16, 32)
    assert used == 2 * rp.MAX_BIN and offsets.tolist() == [0, 300]
    assert indices.tolist() == list(range(300))
    with pytest.raises(OverflowError):
        rp.bin_triangles(np.repeat(one, 300, 0), 16, 32)
    seen = []
    real = rp.bin_triangles
    monkeypatch.setattr(rp, 'bin_triangles', lambda t, h, w, m:
                        (seen.append(m), real(t, h, w, m))[1])
    with pytest.raises(OverflowError):                  # over 4 x 256
        rp.bin_with_retry(np.repeat(one, 1100, 0), 16, 32)
    assert seen == [256, 512, 1024]
    # no triangle at all
    offsets, indices, gh, gw = real(np.zeros((0, 8), np.float32), 40, 40)
    assert (gh, gw) == (3, 2) and offsets.tolist() == [0] * 7
    assert indices.shape == (0,)


def test_kernel_wrapper_refuses_cpu_tensors():
    """There is no CPU form of the kernel: the wrappers raise, the CPU route
    is ops.warp.rasterize_uv."""
    verts, dst, tris = five_point_mesh(64, (1.0, 1.0))
    with pytest.raises(ValueError, match='CUDA'):
        rp.rasterize_uv_cuda(dst, tris, verts / 64, 64, 64, 'cpu')
    tri, uvt = rp.triangle_tables(dst, tris, verts / 64)
    offsets, indices, _, _ = rp.bin_triangles(tri, 64, 64)
    with pytest.raises(ValueError, match='CUDA'):
        rp.rasterize_binned_cuda(torch.tensor(rp.triangle_rows(tri, uvt)),
                                 torch.tensor(offsets),
                                 torch.tensor(indices), 64, 64)
    assert rp.RASTER_UV.launches == 0


# --------------------------------------------------------- the whole warp
@pytest.fixture(scope='module')
def warp_case():
    size = 512
    hair = np.zeros((size, size), np.int32)
    hair[40:260, 90:430] = HAIR_IDX
    face = np.ones((size, size), np.int32)
    face[200:380, 150:350] = HAIR_IDX            # old hair to uncover
    lm = canonical_template_81()
    lm2 = lm.copy()
    lm2[:, 0] += 0.04
    lm2[:, 1] -= 0.02
    return hair, face, lm, lm2


def test_warp_plain_route_matches_jax_xla(warp_case, monkeypatch):
    hair, face, lm, lm2 = warp_case
    monkeypatch.setenv('CTRLHAIR_HOST_RASTER', '0')
    ref = np.asarray(jw.hair_mask_transfer_warp(hair, face, lm, lm2,
                                                out_size=256))
    # numpy in, numpy out; raster=None on the CPU is the plain route
    got = tw.hair_mask_transfer_warp(hair, face, lm, lm2, out_size=256)
    assert isinstance(got, np.ndarray) and got.shape == (256, 256)
    assert got.dtype == np.int32
    agree = (got == ref).mean()
    assert agree >= 0.999, agree
    assert set(np.unique(got)) <= {1, HAIR_IDX, UNKNOWN_LABEL}
    assert (got == HAIR_IDX).sum() > 1000 and (got == UNKNOWN_LABEL).any()
    # CPU tensors in, a CPU tensor out, by the same route
    t = tw.hair_mask_transfer_warp(torch.tensor(hair), torch.tensor(face),
                                   lm, lm2, out_size=256)
    assert isinstance(t, torch.Tensor) and t.dtype == torch.int32
    np.testing.assert_array_equal(t.numpy(), got)
    assert rp.RASTER_UV.launches == 0


@pytest.mark.parametrize('use_arap', [True, False])
def test_warp_host_route_matches_jax_default(warp_case, monkeypatch,
                                             use_arap):
    hair, face, lm, lm2 = warp_case
    monkeypatch.delenv('CTRLHAIR_HOST_RASTER', raising=False)
    ref = jw.hair_mask_transfer_warp(hair, face, lm, lm2, out_size=256,
                                     use_arap=use_arap)
    got = tw.hair_mask_transfer_warp(hair, face, lm, lm2, out_size=256,
                                     use_arap=use_arap, raster='host')
    assert (got == np.asarray(ref)).mean() >= 0.9999
    # full size, and the centroid moves with the landmarks
    full = tw.hair_mask_transfer_warp(hair, face, lm, lm2, raster='host',
                                      use_arap=use_arap)
    assert full.shape == (512, 512)
    np.testing.assert_array_equal(full[::2, ::2], got)
    xs = np.nonzero(full == HAIR_IDX)[1]
    assert xs.mean() > (90 + 429) / 2 + 5


def test_warp_refuses_mixed_or_unknown(warp_case):
    hair, face, lm, lm2 = warp_case
    with pytest.raises(TypeError):
        tw.hair_mask_transfer_warp(hair, torch.tensor(face), lm, lm2)
    with pytest.raises(ValueError, match='raster'):
        tw.hair_mask_transfer_warp(hair, face, lm, lm2, raster='xla')
    with pytest.raises(ValueError, match='raster'):
        # the device alone decides between the kernel and its plain version
        tw.hair_mask_transfer_warp(hair, face, lm, lm2, raster='kernel')
    with pytest.raises(ValueError, match='CUDA'):
        # the kernel never runs off the card, and gives way to nothing
        rp.rasterize_uv_cuda(np.zeros((3, 2)), np.array([[0, 1, 2]]),
                             np.zeros((3, 2)), 8, 8, 'cpu')
    with pytest.raises(ValueError):
        tw.hair_mask_transfer_warp(hair[:100], face[:100], lm, lm2)
