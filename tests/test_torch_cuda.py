# Card-only tests of the PyTorch port: the masked-CG and UV-rasteriser CUDA
# kernels against their plain versions, the warp's kernel route, the
# multigrid blend and the float32 slice on the card against the same on the
# CPU.  They skip without a CUDA device.  This file imports nothing of
# JAX, so on a machine with a card and no JAX it runs without the suite's
# conftest:
#     python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
import numpy as np
import pytest
import torch

from ctrlhair_tpu_torch import config as C
from ctrlhair_tpu_torch.ops.poisson import blend_system, decode_solution
from ctrlhair_tpu_torch.ops import poisson_pallas as pp
from ctrlhair_tpu_torch.ops.poisson_pallas import (
    MASKED_CG, masked_cg, masked_cg_plain)
from ctrlhair_tpu_torch.ops import raster_pallas as rp
from ctrlhair_tpu_torch.ops import warp
from ctrlhair_tpu_torch.ops.landmarks import canonical_template_81
from ctrlhair_tpu_torch.pipeline.editor import HairEditor


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda', 0)


@pytest.mark.cuda
@pytest.mark.parametrize('n', [1, 3])
def test_masked_cg_kernel_matches_plain(card, n):
    """At the main path's shape, float32: within 0.5 on [0,255] after the
    decode, pinned pixels equal to the target within 6e-3."""
    rng = np.random.default_rng(n)
    src = torch.tensor(rng.uniform(0, 255, (n, 256, 256, 3)),
                       dtype=torch.float32, device=card)
    tgt = torch.tensor(rng.uniform(0, 255, (n, 256, 256, 3)),
                       dtype=torch.float32, device=card)
    mask = torch.ones((n, 256, 256), device=card)
    mask[:, 64:192, 64:192] = 0.0
    b, u, x0, fixed, tgt_s, gamma = blend_system(src, tgt, mask)
    before = MASKED_CG.launches
    got = decode_solution(masked_cg(b, u, x0, 200), fixed, tgt_s, gamma)
    torch.cuda.synchronize()
    assert MASKED_CG.launches == before + 1
    want = decode_solution(masked_cg_plain(b, u, x0, 200), fixed, tgt_s,
                           gamma)
    assert float((got - want).abs().max()) <= 0.5
    keep = fixed[:, 0]
    assert float((got[keep] - tgt[keep]).abs().max()) <= 6e-3


def centre_block_system(n, h, w, seed, device):
    rng = np.random.default_rng(seed)
    src = torch.tensor(rng.uniform(0, 255, (n, h, w, 3)),
                       dtype=torch.float32, device=device)
    tgt = torch.tensor(rng.uniform(0, 255, (n, h, w, 3)),
                       dtype=torch.float32, device=device)
    mask = torch.ones((n, h, w), device=device)
    mask[:, h // 4:3 * h // 4, w // 4:3 * w // 4] = 0.0
    return blend_system(src, tgt, mask) + (tgt,)


@pytest.mark.cuda
@pytest.mark.parametrize('name,shape,route', [
    ('more_images_than_clusters', (None, 256, 256), 'cluster'),
    ('ragged', (2, 40, 72), 'cluster'),
    ('fewer_rows_than_blocks', (3, 5, 8), 'cluster'),
    ('tiny_session_size', (1, 64, 64), 'cluster'),
    ('grid_route', (1, 512, 512), 'grid')])
def test_masked_cg_cases_by_route(card, name, shape, route):
    """Each case takes the kernel its shape says, agrees with the plain
    version under the bars of the main path's shape, and a second launch on
    the same input is bit-identical."""
    n, h, w = shape
    if n is None:
        threads = pp.cluster_plan(3, h, w).threads
        n = pp.active_clusters(card.index, threads) + 3
    b, u, x0, fixed, tgt_s, gamma, tgt = centre_block_system(n, h, w, 11,
                                                             card)
    assert pp.masked_cg_route(3, h, w) == route
    before = dict(pp.ROUTE_LAUNCHES)
    x = masked_cg(b, u, x0, 200)
    again = masked_cg(b, u, x0, 200)
    torch.cuda.synchronize()
    other = 'grid' if route == 'cluster' else 'cluster'
    assert pp.ROUTE_LAUNCHES[route] == before[route] + 2
    assert pp.ROUTE_LAUNCHES[other] == before[other]
    assert torch.equal(x, again)
    got = decode_solution(x, fixed, tgt_s, gamma)
    want = decode_solution(masked_cg_plain(b, u, x0, 200), fixed, tgt_s,
                           gamma)
    assert float((got - want).abs().max()) <= 0.5
    keep = fixed[:, 0]
    assert float((got[keep] - tgt[keep]).abs().max()) <= 6e-3


@pytest.mark.cuda
def test_masked_cg_cluster_and_grid_agree(card):
    """The cluster kernel and the grid kernel solve the same system."""
    b, u, x0 = centre_block_system(2, 256, 256, 12, card)[:3]
    want = masked_cg_plain(b, u, x0, 200)
    scale = float(want.abs().max())
    for got in (pp.masked_cg_cluster_cuda(b, u, x0, 200),
                pp.masked_cg_grid_cuda(b, u, x0, 200)):
        assert float((got - want).abs().max()) <= 1e-4 * scale
    with pytest.raises(ValueError, match='cannot hold'):
        pp.masked_cg_cluster_cuda(*centre_block_system(1, 512, 512, 1,
                                                       card)[:3], 5)


@pytest.mark.cuda
def test_masked_cg_cuda_refuses_what_it_does_not_take(card):
    b, u, x0 = centre_block_system(1, 32, 32, 13, card)[:3]
    before = MASKED_CG.launches
    with pytest.raises(ValueError, match='contiguous'):
        pp.masked_cg_cuda(b.transpose(2, 3), u.transpose(2, 3),
                          x0.transpose(2, 3), 5)
    with pytest.raises(ValueError, match='CUDA'):
        pp.masked_cg_cuda(b.cpu(), u, x0, 5)
    with pytest.raises(TypeError):
        pp.masked_cg_cuda(b.double(), u.double(), x0.double(), 5)
    with pytest.raises(ValueError, match='shape'):
        pp.masked_cg_cuda(b, u[:, :2], x0, 5)
    assert MASKED_CG.launches == before


@pytest.mark.cuda
def test_tiny_slice_on_card_matches_cpu(card):
    cfg = C.PipelineConfig(
        sean=C.SEANConfig(crop_size=64, ngf=4, zencoder_ngf=4, style_dim=64),
        bisenet=C.BiSeNetConfig(input_size=128),
        color_texture=C.ColorTextureConfig(style_dim=64),
        shape=C.ShapeConfig(img_size=64, layer_num=5, max_channel=64,
                            hidden_in_channel=8),
        edit_size=64, poisson_iterations=60, compute_dtype='float32')
    gpu = HairEditor(cfg, device=card, seed=1)
    cpu = HairEditor(cfg, device='cpu', seed=1)
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (128, 128, 3), dtype=np.uint8)
    face = rng.integers(0, 256, (1, 64, 64, 3), dtype=np.uint8)
    ag, ac = gpu.analyze_image(img), cpu.analyze_image(img)
    assert (ag['label'].cpu() == ac['label']).float().mean() >= 0.999
    args = (ac['sean_codes'], ac['latent'], face, ac['label'],
            ac['regen_label'])
    before = MASKED_CG.launches
    got = gpu.output(*args).cpu().int()
    assert MASKED_CG.launches == before + 1
    d = (got - cpu.output(*args).int()).abs()
    assert (d <= 1).float().mean() >= 0.999


def warp_mesh_case(name):
    """(verts_dst, tris, uv, size): the warp mesh of a 512 px transfer at
    672 px, the 5-point mesh of tests/test_raster_pallas.py at 64 px, a
    seeded soup of 900 large triangles at 96 px (more than 256 in a tile),
    or no triangle at all."""
    if name == 'session':
        lm = canonical_template_81().astype(np.float64)
        sel = warp.CHOSEN_LANDMARKS
        src = lm[sel] * 512 + warp.BG_PAD
        dst = (lm[sel] * [0.9, 0.95] + [0.06, 0.01]) * 512 + warp.BG_PAD
        size = 512 + 2 * warp.BG_PAD
        verts, vdst, tris = warp.build_warp_mesh(src, dst, size, size)
    elif name == 'five_point':
        size = 64
        src = np.array([[16, 16], [size - 16, 16], [16, size - 16],
                        [size - 16, size - 16], [size / 2, size / 2]], float)
        verts, vdst, tris = warp.build_warp_mesh(
            src, src + np.array([3.0, -2.0]), size, size, use_arap=False)
    elif name == 'crowded':
        size = 96
        rng = np.random.default_rng(3)
        verts = rng.uniform(0, size, (400, 2))
        vdst = verts + rng.normal(0, 1.5, verts.shape)
        tris = rng.integers(0, 400, (900, 3)).astype(np.int32)
    else:
        size = 32
        verts = vdst = np.zeros((3, 2))
        tris = np.full((64, 3), -1, np.int32)
    return vdst, tris, verts / size, size


@pytest.mark.cuda
@pytest.mark.parametrize('name', ['session', 'five_point', 'empty',
                                  'crowded'])
def test_raster_uv_kernel_matches_plain(card, name):
    """float32 on the card: >= 99.5% of pixels within 1e-4 and a median
    difference < 1e-6 (a pixel on a shared edge may go to either triangle);
    with no triangle the identity UV is exact."""
    vdst, tris, uv, size = warp_mesh_case(name)
    if name == 'crowded':
        tri, _ = rp.triangle_tables(vdst, tris, uv)
        assert rp.bin_with_retry(tri, size, size)[4] > rp.MAX_BIN
    before = rp.RASTER_UV.launches
    got = rp.rasterize_uv_cuda(vdst, tris, uv, size, size, card)
    torch.cuda.synchronize()
    assert rp.RASTER_UV.launches == before + 1
    up = lambda a, dt: torch.as_tensor(a, dtype=dt, device=card)
    want = warp.rasterize_uv(up(vdst, torch.float32), up(tris, torch.int64),
                             up(uv, torch.float32), size, size)
    assert got.shape == want.shape == (size, size, 2)
    d = (got - want).abs()
    if name == 'empty':
        assert float(d.max()) == 0.0
    assert float((d < 1e-4).float().mean()) >= 0.995
    assert float(d.median()) < 1e-6


@pytest.mark.cuda
def test_warp_on_card_launches_kernel_and_matches_host(card):
    """raster=None on CUDA tensors is the kernel route; its composite agrees
    with the host C++ route on >= 99.9% of pixels."""
    hair = np.zeros((512, 512), np.int32)
    hair[40:260, 90:430] = 13
    face = np.ones((512, 512), np.int32)
    face[200:380, 150:350] = 13
    lm = canonical_template_81()
    lm2 = lm.copy()
    lm2[:, 0] += 0.04
    lm2[:, 1] -= 0.02
    before = rp.RASTER_UV.launches
    got = warp.hair_mask_transfer_warp(
        torch.tensor(hair, device=card), torch.tensor(face, device=card),
        lm, lm2, out_size=256)
    torch.cuda.synchronize()
    assert rp.RASTER_UV.launches == before + 1
    assert got.device == card and got.shape == (256, 256)
    host = warp.hair_mask_transfer_warp(hair, face, lm, lm2, out_size=256,
                                        raster='host')
    assert rp.RASTER_UV.launches == before + 1
    assert (got.cpu().numpy() == host).mean() >= 0.999


@pytest.mark.cuda
@pytest.mark.parametrize('h,w', [(64, 64), (68, 68), (256, 256), (63, 64)])
def test_multigrid_blend_on_card_matches_cpu(card, h, w):
    """poisson_blend(method='mg') on CUDA tensors within 0.05 of the same
    call on the CPU (the bar of chip_smoke.py); the V-cycles launch no
    masked CG, the odd-size fallback one."""
    from ctrlhair_tpu_torch.ops.poisson import poisson_blend
    rng = np.random.default_rng(h + w)
    src = rng.uniform(0, 255, (h, w, 3)).astype(np.float32)
    tgt = rng.uniform(0, 255, (h, w, 3)).astype(np.float32)
    mask = np.zeros((h, w), np.float32)
    mask[h // 6:5 * h // 6, w // 6:5 * w // 6] = 1.0
    args = [torch.from_numpy(a) for a in (src, tgt, mask)]
    before = MASKED_CG.launches
    got = poisson_blend(*(a.to(card) for a in args), method='mg')
    torch.cuda.synchronize()
    assert MASKED_CG.launches == before + (h % 2 or w % 2)
    want = poisson_blend(*args, method='mg')
    assert got.device == card and torch.isfinite(got).all()
    assert float((got.cpu() - want).abs().max()) <= 0.05
