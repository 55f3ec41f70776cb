# The port's small ops against their JAX twins on the same numpy inputs:
# masks, colour space (exact on a uint8 grid), resizes (both conventions),
# morphology (exact), the Poisson blend (its masked-CG core and the
# multigrid method).  The JAX side of the Pallas blend runs in interpret
# mode, as its own tests run it.
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctrlhair_tpu.ops import morphology as jmorph
from ctrlhair_tpu.ops import resize as jresize
from ctrlhair_tpu.ops.poisson import _laplacian_full as j_laplacian_full
from ctrlhair_tpu.ops.poisson import poisson_blend as j_poisson_blend
from ctrlhair_tpu.ops.poisson_pallas import \
    poisson_blend_fused as j_poisson_blend_fused
from ctrlhair_tpu.utils import colorspace as jcolor
from ctrlhair_tpu.utils import masks as jmasks
from ctrlhair_tpu_torch.ops import morphology, resize
from ctrlhair_tpu_torch.ops.poisson import (
    _laplacian_full, blend_system, poisson_blend)
from ctrlhair_tpu_torch.ops.poisson_pallas import (
    MASKED_CG, masked_cg, masked_cg_cuda, masked_cg_plain,
    poisson_blend_fused)
from ctrlhair_tpu_torch.utils import colorspace, masks

T = torch.from_numpy


# ------------------------------------------------------------------ masks
def test_masks_match_jax():
    rng = np.random.default_rng(0)
    label = rng.integers(0, 19, (2, 16, 16)).astype(np.int32)
    label[0, :3, :3] = 255
    oh = masks.label_to_one_hot(T(label)).numpy()
    np.testing.assert_array_equal(
        oh, np.asarray(jmasks.label_to_one_hot(jnp.asarray(label))))
    soft = rng.random((2, 16, 16, 19)).astype(np.float32)
    soft[1, 2:5, 2:5] = 0.0
    np.testing.assert_array_equal(
        masks.one_hot_to_label(T(soft)).numpy(),
        np.asarray(jmasks.one_hot_to_label(jnp.asarray(soft))))
    hair, face = masks.split_hair_face(T(oh))
    jh, jf = jmasks.split_hair_face(jnp.asarray(oh))
    np.testing.assert_array_equal(hair.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(face.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(masks.merge_hair_face(hair, face).numpy(),
                                  oh)


def test_region_areas_match_jax():
    """Per-region pixel counts, exactly, on one-hot masks with unknown
    pixels and on soft masks (eighths, so that every order of summing is
    exact), with and without a batch axis."""
    rng = np.random.default_rng(1)
    label = rng.integers(0, 19, (3, 12, 10)).astype(np.int32)
    label[1, 4:7, :] = 255
    oh = masks.label_to_one_hot(T(label))
    soft = T((rng.integers(0, 9, (2, 9, 7, 19)) / 8).astype(np.float32))
    for x in (oh, oh[0], soft):
        got = masks.region_areas(x)
        want = np.asarray(jmasks.region_areas(jnp.asarray(x.numpy())))
        assert got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), want)
    assert masks.region_areas(oh).sum().item() == 3 * 12 * 10 - 30


# ------------------------------------------------------------- colorspace
def test_rgb_to_hsv_exact_on_uint8_grid():
    v = np.arange(0, 256, 5, dtype=np.uint8)
    rgb = np.stack(np.meshgrid(v, v, v, indexing='ij'), -1).reshape(-1, 3)
    np.testing.assert_array_equal(
        colorspace.rgb_to_hsv_u8(T(rgb)).numpy(),
        np.asarray(jcolor.rgb_to_hsv_u8(jnp.asarray(rgb))))


def test_hsv_to_rgb_exact_on_uint8_grid():
    h = np.arange(0, 180, dtype=np.uint8)
    sv = np.arange(0, 256, 15, dtype=np.uint8)
    hsv = np.stack(np.meshgrid(h, sv, sv, indexing='ij'), -1).reshape(-1, 3)
    np.testing.assert_array_equal(
        colorspace.hsv_to_rgb_u8(T(hsv)).numpy(),
        np.asarray(jcolor.hsv_to_rgb_u8(jnp.asarray(hsv))))


# ---------------------------------------------------------------- resize
@pytest.mark.parametrize('out_hw', [(16, 16), (24, 40), (80, 48)])
def test_resize_nearest_matches_jax(out_hw):
    rng = np.random.default_rng(1)
    label = rng.integers(0, 19, (2, 32, 48)).astype(np.int32)
    np.testing.assert_array_equal(
        resize.resize_nearest(T(label), out_hw).numpy(),
        np.asarray(jresize.resize_nearest(jnp.asarray(label), out_hw)))
    img = rng.random((2, 32, 48, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        resize.resize_nearest_nhwc(T(img), out_hw).numpy(),
        np.asarray(jresize.resize_nearest_nhwc(jnp.asarray(img), out_hw)))


@pytest.mark.parametrize('align_corners', [False, True])
@pytest.mark.parametrize('out_hw', [(64, 64), (20, 36), (128, 96)])
def test_resize_bilinear_matches_jax(out_hw, align_corners):
    rng = np.random.default_rng(2)
    img = (rng.random((2, 32, 48, 3)) * 255).astype(np.float32)
    got = resize.resize_bilinear_nhwc(T(img), out_hw, align_corners)
    ref = jresize.resize_bilinear_nhwc(jnp.asarray(img), out_hw,
                                       align_corners)
    # atol 1e-5 relative to the data range: both sum the same two weighted
    # taps, in other orders
    np.testing.assert_allclose(got.numpy() / 255.0, np.asarray(ref) / 255.0,
                               atol=1e-5)


def test_upsample_and_label_pyramid_match_jax():
    rng = np.random.default_rng(3)
    x = rng.random((2, 5, 7, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        resize.upsample2x_nearest_nhwc(T(x)).numpy(),
        np.asarray(jresize.upsample2x_nearest_nhwc(jnp.asarray(x))))
    label = rng.integers(0, 19, (2, 64, 64)).astype(np.int32)
    sizes = (2, 4, 8, 16, 32, 64)
    got = resize.downsample_label_pyramid(T(label), sizes)
    ref = jresize.downsample_label_pyramid(jnp.asarray(label), sizes)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


# ------------------------------------------------------------- morphology
@pytest.mark.parametrize('k', [5, 13, 19])
def test_morphology_exact_vs_jax(k):
    rng = np.random.default_rng(k)
    sparse = (rng.random((2, 48, 48)) > 0.9).astype(np.float32)
    border = np.zeros((1, 48, 48), np.float32)
    border[0, :20, :30] = 1.0       # touches the frame: border semantics
    np.testing.assert_array_equal(morphology.ellipse_kernel(k),
                                  jmorph.ellipse_kernel(k))
    for m in (sparse, border):
        np.testing.assert_array_equal(
            morphology.dilate(T(m), k).numpy(),
            np.asarray(jmorph.dilate(jnp.asarray(m), k)))
        np.testing.assert_array_equal(
            morphology.erode(T(m), k).numpy(),
            np.asarray(jmorph.erode(jnp.asarray(m), k)))


# ---------------------------------------------------------------- poisson
def test_laplacian_matches_jax():
    x = np.random.default_rng(4).random((20, 24, 3)).astype(np.float32)
    np.testing.assert_allclose(_laplacian_full(T(x)).numpy(),
                               np.asarray(j_laplacian_full(jnp.asarray(x))),
                               atol=1e-5)


def _uniform_pair(rng, s):
    src = rng.uniform(0, 255, (1, s, s, 3)).astype(np.float32)
    tgt = rng.uniform(0, 255, (1, s, s, 3)).astype(np.float32)
    return src, tgt


def test_blend_fused_centre_block_matches_jax(rng):
    """The JAX package's centre-block case: the port's fused blend (CPU:
    the plain CG) within 0.2 of the JAX fused blend and of its XLA CG at
    600 iterations."""
    s = 48
    src, tgt = _uniform_pair(rng, s)
    mask = np.ones((1, s, s), np.float32)
    mask[0, 12:36, 12:36] = 0.0
    got = poisson_blend_fused(T(src), T(tgt), T(mask), iterations=600)
    ref_fused = j_poisson_blend_fused(jnp.asarray(src), jnp.asarray(tgt),
                                      jnp.asarray(mask), iterations=600,
                                      interpret=True)
    ref_cg = j_poisson_blend(jnp.asarray(src[0]), jnp.asarray(tgt[0]),
                             jnp.asarray(mask[0]), method='cg',
                             iterations=600)
    assert float(np.abs(got.numpy() - np.asarray(ref_fused)).max()) < 0.2
    assert float(np.abs(got.numpy()[0] - np.asarray(ref_cg)).max()) < 0.2
    one = poisson_blend(T(src[0]), T(tgt[0]), T(mask[0]), iterations=600)
    assert float(np.abs(one.numpy() - np.asarray(ref_cg)).max()) < 0.2


def test_blend_fused_identity_outside_mask(rng):
    s = 32
    src, tgt = _uniform_pair(rng, s)
    mask = np.zeros((1, s, s), np.float32)
    mask[0, 4:20, 4:28] = 1.0
    out = poisson_blend_fused(T(src), T(tgt), T(mask), iterations=200)
    ref = j_poisson_blend_fused(jnp.asarray(src), jnp.asarray(tgt),
                                jnp.asarray(mask), iterations=200,
                                interpret=True)
    keep = np.zeros((s, s), bool)
    keep[1:-1, 1:-1] = True
    keep &= mask[0] == 0
    np.testing.assert_allclose(out.numpy()[0][keep], tgt[0][keep],
                               atol=6e-3)
    assert float(np.abs(out.numpy() - np.asarray(ref)).max()) < 0.2


def test_masked_cg_dispatch_on_cpu():
    """CPU tensors take the plain version and count no launch; the kernel
    wrapper refuses them instead of falling back; other devices raise."""
    rng = np.random.default_rng(5)
    src, tgt = _uniform_pair(rng, 16)
    mask = (rng.random((1, 16, 16)) > 0.5).astype(np.float32)
    b, u, x0 = blend_system(T(src), T(tgt), T(mask))[:3]
    before = MASKED_CG.launches
    np.testing.assert_array_equal(masked_cg(b, u, x0, 20).numpy(),
                                  masked_cg_plain(b, u, x0, 20).numpy())
    assert MASKED_CG.launches == before
    with pytest.raises(ValueError):
        masked_cg_cuda(b, u, x0, 20)
    with pytest.raises(ValueError):
        masked_cg(b.to('meta'), u.to('meta'), x0.to('meta'), 20)


# --------------------------------------------------------------- multigrid
# poisson_blend(method='mg') against the JAX 'mg' on the same inputs: the
# same V-cycles in float32, summed in other orders, stay within 0.01 on
# [0,255] (measured: at most 1.2e-3 at 256 px).  The odd-size case falls
# back to CG on both sides (the port's fused blend, the JAX XLA CG, 300
# iterations each), within the same bar.
MG_BAR = 0.01


def _mg_case(rng, h, w, kind):
    src = rng.uniform(0, 255, (h, w, 3)).astype(np.float32)
    tgt = rng.uniform(0, 255, (h, w, 3)).astype(np.float32)
    mask = np.zeros((h, w), np.float32)
    if kind == 'block':
        mask[h // 6:5 * h // 6, w // 6:5 * w // 6] = 1.0
    else:                                   # a ragged random region
        mask[rng.random((h, w)) > 0.4] = 1.0
    return src, tgt, mask


@pytest.mark.parametrize('h,w,kind', [
    (64, 64, 'block'), (64, 64, 'ragged'),
    (68, 68, 'block'),        # the odd halving chain 68 -> 34 -> 17
    (256, 256, 'block'),
    (63, 64, 'block'),        # odd H: CG fallback
    (48, 35, 'ragged'),       # odd W: CG fallback
])
def test_multigrid_blend_matches_jax(h, w, kind):
    rng = np.random.default_rng(h * 1000 + w)
    src, tgt, mask = _mg_case(rng, h, w, kind)
    got = poisson_blend(T(src), T(tgt), T(mask), method='mg').numpy()
    ref = np.asarray(j_poisson_blend(jnp.asarray(src), jnp.asarray(tgt),
                                     jnp.asarray(mask), method='mg'))
    assert got.shape == ref.shape == (h, w, 3) and np.isfinite(got).all()
    assert float(np.abs(got - ref).max()) < MG_BAR


def test_multigrid_pyramid_and_fallback():
    """The unknown pyramid stops at <= 16 rows or at an odd side, as the
    JAX twin's; an odd size takes the fused CG (no launch on the CPU); an
    unknown method raises."""
    from ctrlhair_tpu.ops.poisson import _build_unknown_pyramid as j_pyramid
    from ctrlhair_tpu_torch.ops.poisson import _build_unknown_pyramid
    rng = np.random.default_rng(1)
    for h, w in ((256, 256), (68, 68), (272, 272), (64, 36)):
        unk = (rng.random((h, w, 1)) > 0.3).astype(np.float32)
        ref = j_pyramid(jnp.asarray(unk))
        got = _build_unknown_pyramid(
            T(np.ascontiguousarray(unk.transpose(2, 0, 1)))[None])
        assert [tuple(g.shape[-2:]) for g in got] == \
            [tuple(r.shape[:2]) for r in ref]
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g[0, 0].numpy(),
                                          np.asarray(r)[..., 0])
    src, tgt, mask = _mg_case(rng, 31, 40, 'block')
    before = MASKED_CG.launches
    got = poisson_blend(T(src), T(tgt), T(mask), method='mg', iterations=50)
    want = poisson_blend_fused(T(src)[None], T(tgt)[None], T(mask)[None],
                               50)[0]
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert MASKED_CG.launches == before
    with pytest.raises(ValueError):
        poisson_blend(T(src), T(tgt), T(mask), method='sor')
