# What surrounds the port's two CUDA kernels and runs without a card: the
# cluster plan of the masked-CG solve (csrc/masked_cg.cu) and the rule that
# picks its kernel, a plain-torch CG that follows the plan band by band,
# and the packed tile binning and per-triangle rows of the UV rasteriser
# (csrc/raster_uv.cu).
#
# Tolerances.  The banded CG does the plain version's arithmetic with its
# dot products summed in another order (band partials in rank order), so
# it agrees with `masked_cg_plain` within 1e-4 of the solution's largest
# value, and with the JAX package's Pallas kernel (interpret mode) within
# 0.2 on [0,255] after the decode, the bar of the existing blend tests.
# Binning and rows are integer or bit-exact float32 facts: equality.
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ctrlhair_tpu.ops.poisson_pallas import pallas_masked_cg
from ctrlhair_tpu_torch.ops import poisson_pallas as pp
from ctrlhair_tpu_torch.ops import raster_pallas as rp
from ctrlhair_tpu_torch.ops import warp as tw
from ctrlhair_tpu_torch.ops.landmarks import canonical_template_81
from ctrlhair_tpu_torch.ops.poisson import blend_system, decode_solution


# ------------------------------------------------------------ cluster plan
PLAN_SHAPES = [(3, 256, 256), (3, 40, 72), (3, 64, 64), (3, 5, 8),
               (1, 17, 768), (3, 255, 256), (2, 1, 1), (3, 16, 16),
               (3, 15, 256), (3, 241, 256), (3, 128, 200), (1, 256, 768),
               (2, 33, 384), (3, 100, 1)]


@pytest.mark.parametrize('shape', PLAN_SHAPES)
def test_cluster_plan_bands_cover_every_row_once(shape):
    c, h, w = shape
    cluster_size = pp.CLUSTER_SIZE
    plan = pp.cluster_plan(c, h, w)
    assert plan is not None and plan.shape == shape
    assert cluster_size == len(plan.bands)
    assert plan.rows == -(-h // cluster_size) <= pp.BAND_ROWS
    # in order, gapless, each band at most `rows` rows, only the last
    # working band ragged, the blocks after it empty
    assert plan.bands[0][0] == 0 and plan.bands[-1][1] == h
    for k, (lo, hi) in enumerate(plan.bands):
        assert 0 <= hi - lo <= plan.rows
        if k:
            assert lo == plan.bands[k - 1][1]
        assert (hi > lo) == (k < plan.working)
        if k < plan.working - 1:
            assert hi - lo == plan.rows
    covered = np.concatenate([np.arange(lo, hi) for lo, hi in plan.bands])
    np.testing.assert_array_equal(covered, np.arange(h))
    assert 1 <= plan.working <= cluster_size
    assert plan.threads % 32 == 0 and c * w <= plan.threads
    assert plan.threads <= pp.CLUSTER_THREADS
    assert plan.smem_bytes == pp.CLUSTER_SMEM_BYTES <= pp.BLOCK_SMEM_LIMIT


def test_cluster_plan_bytes_at_the_edit_size():
    """[3,256,256]: r, p, ap and unk as floats, 16 rows of 768 columns a
    block, and the slots of the dot products."""
    plan = pp.cluster_plan(3, 256, 256)
    assert (plan.rows, plan.working, plan.threads) == (16, 16, 768)
    assert plan.smem_bytes == 4 * 16 * 768 * 4 + (32 + 2 * 16) * 4
    assert plan.smem_bytes < 232448


@pytest.mark.parametrize('shape,route', [
    ((3, 256, 256), 'cluster'), ((3, 40, 72), 'cluster'),
    ((3, 64, 64), 'cluster'), ((3, 16, 16), 'cluster'),
    ((3, 512, 512), 'grid'), ((3, 1024, 1024), 'grid'),
    ((3, 257, 256), 'grid'),        # a band of 17 rows
    ((3, 64, 257), 'grid'),         # 771 columns, more than a block's threads
    ((1, 256, 768), 'cluster'), ((4, 256, 256), 'grid')])
def test_masked_cg_route_is_a_rule_of_the_shape(shape, route):
    assert pp.masked_cg_route(*shape) == route
    assert (pp.cluster_plan(*shape) is None) == (route == 'grid')


def test_cluster_entry_refuses_what_no_cluster_holds():
    """On the CPU every kernel entry raises; the cluster entry names the
    shape it cannot hold before anything touches a device."""
    z = torch.zeros(1, 3, 8, 8)
    before = (dict(pp.ROUTE_LAUNCHES), pp.MASKED_CG.launches)
    for fn in (pp.masked_cg_cuda, pp.masked_cg_grid_cuda,
               pp.masked_cg_cluster_cuda):
        with pytest.raises(ValueError, match='CUDA'):
            fn(z, z, z, 5)
    assert (dict(pp.ROUTE_LAUNCHES), pp.MASKED_CG.launches) == before


# ------------------------------------------------- the banded CG, in torch
def banded_masked_cg(b_eff, unk, x0, iterations, plan):
    """`masked_cg_plain`'s recurrence the way the cluster kernel runs it:
    every block keeps its band of rows, the stencil's rows above and below
    a band come from the neighbouring bands (zeros at the image's edge),
    and a dot product is the bands' partial sums added in rank order."""
    bands = [(lo, hi) for lo, hi in plan.bands if hi > lo]
    h = b_eff.shape[2]

    def rows_of(v, lo, hi):
        # rows lo-1 .. hi of v, zeros beyond the image
        pad = torch.zeros_like(v[:, :, :1])
        top = v[:, :, lo - 1:lo] if lo > 0 else pad
        bot = v[:, :, hi:hi + 1] if hi < h else pad
        return torch.cat([top, v[:, :, lo:hi], bot], 2)

    def a_op(v):
        out = []
        for lo, hi in bands:
            m = rows_of(v * unk, lo, hi)
            mid = m[:, :, 1:-1]
            left = torch.nn.functional.pad(mid, (1, 0))[..., :-1]
            right = torch.nn.functional.pad(mid, (0, 1))[..., 1:]
            y = 4.0 * mid
            y = y - m[:, :, :-2]
            y = y - m[:, :, 2:]
            y = y - left
            y = y - right
            out.append(y * unk[:, :, lo:hi])
        return torch.cat(out, 2)

    def dot(a, b):
        total = torch.zeros((a.shape[0], 1, 1, 1))
        for lo, hi in bands:
            total = total + (a[:, :, lo:hi] * b[:, :, lo:hi]).sum(
                dim=(1, 2, 3), keepdim=True)
        return total

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


@pytest.mark.parametrize('n,h,w', [(1, 48, 48), (2, 40, 72), (1, 13, 20)])
def test_banded_cg_matches_plain_and_pallas(n, h, w):
    rng = np.random.default_rng(h)
    src = rng.uniform(0, 255, (n, h, w, 3)).astype(np.float32)
    tgt = rng.uniform(0, 255, (n, h, w, 3)).astype(np.float32)
    mask = np.ones((n, h, w), np.float32)
    mask[:, h // 4:3 * h // 4, w // 4:3 * w // 4] = 0.0
    b, u, x0, fixed, tgt_s, gamma = blend_system(
        torch.tensor(src), torch.tensor(tgt), torch.tensor(mask))
    plan = pp.cluster_plan(3, h, w)
    assert plan is not None
    assert (plan.working < pp.CLUSTER_SIZE) == (h < 16 or h == 40)
    iters = 80
    got = banded_masked_cg(b, u, x0, iters, plan)
    want = pp.masked_cg_plain(b, u, x0, iters)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-4 * scale
    ref = pallas_masked_cg(jnp.asarray(b.numpy()), jnp.asarray(u.numpy()),
                           jnp.asarray(x0.numpy()), iterations=iters,
                           interpret=True)
    out = decode_solution(got, fixed, tgt_s, gamma).numpy()
    out_ref = decode_solution(torch.tensor(np.asarray(ref)), fixed, tgt_s,
                              gamma).numpy()
    assert float(np.abs(out - out_ref).max()) < 0.2


# ----------------------------------------------------------- packed binning
def padded_bins(tri, height, width, max_bin):
    """The padded layout the kernel read before the packed one: [G,
    max_bin] int32 indices per tile, ascending, -1 beyond the count, and
    the counts.  Built by the brute-force rule, one triangle at a time."""
    gh, gw = -(-height // rp.TILE_H), -(-width // rp.TILE_W)
    bins = np.full((gh * gw, max_bin), -1, np.int32)
    counts = np.zeros(gh * gw, np.int32)
    for t, row in enumerate(tri):
        xs, ys = row[0:6:2], row[1:6:2]
        y0, y1 = (int(np.clip(v // rp.TILE_H, 0, gh - 1))
                  for v in (ys.min(), ys.max()))
        x0, x1 = (int(np.clip(v // rp.TILE_W, 0, gw - 1))
                  for v in (xs.min(), xs.max()))
        for gy in range(y0, y1 + 1):
            for gx in range(x0, x1 + 1):
                g = gy * gw + gx
                bins[g, counts[g]] = t
                counts[g] += 1
    return bins, counts


def mesh_case(name):
    """The meshes of tests/test_torch_warp.py: (verts_dst, tris, uv, size)."""
    if name == 'transfer':
        lm = canonical_template_81().astype(np.float64)
        sel = tw.CHOSEN_LANDMARKS
        src = lm[sel] * 512 + tw.BG_PAD
        dst = (lm[sel] * [0.9, 0.95] + [0.06, 0.01]) * 512 + tw.BG_PAD
        size = 512 + 2 * tw.BG_PAD
        verts, vdst, tris = tw.build_warp_mesh(src, dst, size, size)
    else:
        size = {'five_point_64': 64, 'five_point_100': 100}[name]
        src = np.array([[16, 16], [size - 16, 16], [16, size - 16],
                        [size - 16, size - 16], [size / 2, size / 2]], float)
        verts, vdst, tris = tw.build_warp_mesh(
            src, src + np.array([3.0, -2.0]), size, size, use_arap=False)
    return vdst, tris, verts / size, size


@pytest.mark.parametrize('name', ['transfer', 'five_point_64',
                                  'five_point_100'])
def test_packed_bins_equal_padded_layout(name):
    vdst, tris, uv, size = mesh_case(name)
    tri, uvt = rp.triangle_tables(vdst, tris, uv)
    offsets, indices, gh, gw, budget = rp.bin_with_retry(tri, size, size)
    bins, counts = padded_bins(tri, size, size, budget)
    assert (gh, gw) == (-(-size // rp.TILE_H), -(-size // rp.TILE_W))
    np.testing.assert_array_equal(np.diff(offsets), counts)
    assert counts.max() <= budget
    assert budget == rp.MAX_BIN or counts.max() > budget // 2
    for g in range(gh * gw):
        np.testing.assert_array_equal(indices[offsets[g]:offsets[g + 1]],
                                      bins[g, :counts[g]])
    # one upload: the three tables as one array, and back
    rows = rp.triangle_rows(tri, uvt)
    words = torch.from_numpy(rp.pack_tables(rows, offsets, indices))
    assert words.dtype == torch.int32
    assert words.numel() == rows.size + offsets.size + indices.size
    r, o, i = rp.unpack_tables(words, len(tri), gh * gw)
    np.testing.assert_array_equal(r.numpy(), rows)
    np.testing.assert_array_equal(o.numpy(), offsets)
    np.testing.assert_array_equal(i.numpy(), indices)
    # far smaller than the padded table it replaces
    assert words.numel() * 4 < bins.nbytes + counts.nbytes + 2 * tri.nbytes


@pytest.mark.parametrize('copies,budget', [(200, 256), (300, 512),
                                           (600, 1024), (1100, None)])
def test_budget_retry_is_a_check_on_the_counts(copies, budget):
    """256 -> 512 -> 1024 -> OverflowError, whatever the packed arrays
    could hold."""
    one = np.array([[2, 2, 12, 2, 2, 12, 0, 0]], np.float32)
    tri = np.repeat(one, copies, 0)
    if budget is None:
        with pytest.raises(OverflowError):
            rp.bin_with_retry(tri, 16, 32)
        return
    offsets, indices, gh, gw, used = rp.bin_with_retry(tri, 16, 32)
    assert used == budget and (gh, gw) == (1, 1)
    assert offsets.tolist() == [0, copies]
    assert indices.tolist() == list(range(copies))
    if budget > rp.MAX_BIN:
        with pytest.raises(OverflowError):
            rp.bin_triangles(tri, 16, 32, budget // 2)


@pytest.mark.parametrize('name', ['transfer', 'five_point_64', 'degenerate'])
def test_triangle_rows_sign_and_area_equal_plain(name):
    """Columns 6 and 7 of a row, bit for bit what ops/warp.rasterize_uv
    computes for the triangle in float32."""
    if name == 'degenerate':
        vdst = np.array([[0, 0], [5, 0], [0, 5], [5, 0], [1e-7, 0],
                         [3, 3]], np.float64)
        tris = np.array([[0, 1, 2], [0, 2, 1], [1, 3, 5], [0, 4, 0],
                         [-1, 0, 0]], np.int32)
        uv = vdst / 8
    else:
        vdst, tris, uv, _ = mesh_case(name)
    tri, uvt = rp.triangle_tables(vdst, tris, uv)
    rows = rp.triangle_rows(tri, uvt)
    v = torch.tensor(vdst, dtype=torch.float32)
    idx = torch.tensor(tris[tris[:, 0] >= 0]).long()
    a, b, c = (v[idx[:, k]] for k in range(3))
    area = ((b[:, 0] - a[:, 0]) * (c[:, 1] - a[:, 1])
            - (b[:, 1] - a[:, 1]) * (c[:, 0] - a[:, 0]))
    s = torch.where(area >= 0, 1.0, -1.0)
    inv_area = s / torch.clamp(torch.abs(area), min=1e-12)
    assert rows.shape == (len(idx), 16)
    np.testing.assert_array_equal(rows[:, 6], s.numpy())
    np.testing.assert_array_equal(rows[:, 7], inv_area.numpy())
    assert (rows[:, 7] != 0).all()      # 0 marks a row to skip in the kernel
    np.testing.assert_array_equal(rows[:, 0:2], a.numpy())
    np.testing.assert_array_equal(rows[:, 4:6], c.numpy())
