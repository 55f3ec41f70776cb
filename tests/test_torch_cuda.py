# Card-only tests of the PyTorch port: the masked-CG and UV-rasteriser CUDA
# kernels against their plain versions, the warp's kernel route, the
# multigrid blend, the float32 slice on the card against the same on the
# CPU, ChunkRunner's CUDA graphs against the same steps taken eagerly, and
# the editor's render replayed as a CUDA graph against its eager render
# (pipeline/stage_graph.py), bit for bit.
# ChunkRunner runs the tiny shape, landmark, colour/texture, predictor,
# face-parser and SEAN trainers, and the face parser over a one-rank NCCL
# group, fresh and after eager steps whose tensors the caller copied.
# They skip without a CUDA device.  This file imports nothing of JAX, so
# on a machine with a card and no JAX it runs without the suite's
# conftest:
#     python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
import copy

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


def _leaves(t, p=()):
    if isinstance(t, dict):
        for k in sorted(t):
            yield from _leaves(t[k], p + (k,))
    elif t is not None:              # the SEAN state's u trees hold None
        yield p, np.asarray(t)


def _step_distance(got, ref, init, lrs):
    """(largest scaled difference, its leaf) of one train step's state
    `got` from `ref`, both from `init`: every leaf's difference scaled by
    the larger of 1 and the leaf's largest magnitude in `ref`, Adam's mu
    (the gradient) included; a parameter entry whose gradient the two do
    not reproduce to 1% is rounding noise, which Adam scales to a step of
    about lr of either sign (a bias that a batch-statistics BatchNorm
    cancels, a WGAN critic's bias of a unit with the same slope on every
    sample), and is held to a move of at most 2 lr instead."""
    got, ref = copy.deepcopy(got), copy.deepcopy(ref)
    for part, lr in lrs.items():
        mu_g, mu_r = (dict(_leaves(t[part]['opt_state']['0']['mu']))
                      for t in (got, ref))
        p0 = dict(_leaves(init[part]['params']))
        sides = [dict(_leaves(t[part]['params'])) for t in (got, ref)]
        for path, m in mu_r.items():
            noisy = np.abs(mu_g[path] - m) > 1e-2 * np.abs(m)
            for side in sides:
                assert np.all(np.abs(side[path] - p0[path])[noisy]
                              <= 2 * lr), path
                side[path] = np.where(noisy, 0.0, side[path])
        got[part]['params'], ref[part]['params'] = sides
    g, r = list(_leaves(got)), list(_leaves(ref))
    assert [p for p, _ in g] == [p for p, _ in r]
    worst = (0.0, None)
    for (path, a), (_, b) in zip(g, r):
        if b.size:
            scale = max(1.0, float(np.abs(b).max()))
            err = float(np.abs(a - b).max()) / scale
            if err >= worst[0]:
                worst = (err, path)
    return worst


def _hold_step(card, cpu, init, lrs, bar=1e-4):
    """A train step on the card against the CPU's from the same state:
    every leaf within `bar` of the CPU's, as _step_distance measures it."""
    err, path = _step_distance(card, cpu, init, lrs)
    assert err <= bar, (path, err)


# A float32 step as the trainers take it, the card's and the CPU's, against
# the CPU's float64 step from the same state: within FLOAT32_BAR, as
# _step_distance measures it.  The bar lies between the card's float32
# readings and the same step with TF32 on (cuDNN's and cuBLAS's 10-bit
# products), which each test also takes and holds above the bar, so that a
# card that rounds to TF32 fails.  Readings (H100, torch 2.11): PERF.md.
FLOAT32_BAR = 5e-3


def _float32_against_float64(run_step, init, lrs):
    """{'card', 'cpu', 'card_tf32'}: the distance of each float32 step from
    the CPU's float64 step.  run_step(device, dtype) -> the state's tree
    after one step from `init`, the models computing in `dtype`."""
    ref = run_step('cpu', torch.float64)
    out = {}
    for name, device, tf32 in (('cpu', 'cpu', False), ('card', 'cuda', False),
                               ('card_tf32', 'cuda', True)):
        torch.backends.cudnn.allow_tf32 = tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            tree = run_step(device, torch.float32)
        finally:
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        out[name] = _step_distance(tree, ref, init, lrs)
    print('float32 against float64:', out)
    return {k: v[0] for k, v in out.items()}


def _hold_float32(readings):
    """The card's float32 step within FLOAT32_BAR of the float64 step, and
    the TF32 step outside it."""
    assert readings['cpu'] <= FLOAT32_BAR, readings
    assert readings['card'] <= FLOAT32_BAR, readings
    assert readings['card_tf32'] > FLOAT32_BAR, readings


@pytest.mark.cuda
def test_ct_train_step_on_card_matches_cpu(card):
    """One colour/texture step (lambda_rec_img on, through a small SEAN) on
    the card against the CPU from the same state, batch and draws, held as
    _hold_step says."""
    import dataclasses
    from ctrlhair_tpu_torch.models.layers import init_parameters_
    from ctrlhair_tpu_torch.models.sean import SEAN
    from ctrlhair_tpu_torch.training.color_texture_trainer import (
        ColorTextureTrainer, synthetic_batch)
    cfg = dataclasses.replace(
        C.ColorTextureConfig(style_dim=64, g_hidden_dim=32, d_hidden_dim=32),
        lambda_rec_img={0: 10.0})
    scfg = C.SEANConfig(crop_size=32, ngf=2, zencoder_ngf=2, style_dim=64)
    sean = SEAN(scfg)
    init_parameters_(sean, torch.Generator().manual_seed(0))
    batch = synthetic_batch(torch.Generator().manual_seed(1), cfg, 16)
    g = torch.Generator().manual_seed(2)
    batch['sean_code'] = torch.randn((16, 19, 64), generator=g)
    batch['label'] = torch.randint(0, 19, (16, 32, 32), generator=g)
    batch['image'] = torch.rand((16, 32, 32, 3), generator=g) * 2 - 1
    trees, preds0 = [], None
    for device in ('cpu', 'cuda'):
        tr = ColorTextureTrainer(cfg, sean=sean.to(device), device=device)
        state, preds = tr.init_state(0)
        if preds0 is None:
            init, preds0 = state.to_tree(), preds
        else:
            state.load_tree(init)
            for k in preds:
                preds[k].load_state_dict(preds0[k].state_dict())
        draws = tr.draws(0, 16)
        state, m = tr.train_step(
            state, {k: v.to(device) for k, v in batch.items()}, preds,
            draws)
        assert bool(m['finite']) and 'g/lambda_rec_img' in m
        trees.append(state.to_tree())
    _hold_step(trees[1], trees[0], init,
               {'gen': cfg.lr_g, 'dis': cfg.lr_d, 'dis_noise': cfg.lr_g})


@pytest.mark.cuda
def test_predictor_train_step_on_card_matches_cpu(card):
    """One rgb-predictor step on the card against the CPU, held as
    _hold_step says."""
    from ctrlhair_tpu_torch.training.predictor_trainer import (
        PredictorTrainer)
    cfg = C.PredictorConfig(style_dim=64, hidden_dim=32)
    g = torch.Generator().manual_seed(3)
    code = torch.randn((64, 64), generator=g)
    batch = {'code': code, 'rgb_mean': code[:, :3] * 40 + 128,
             'pca_std': code[:, 3:4].abs() * 30 + 20}
    trees = []
    for device in ('cpu', 'cuda'):
        tr = PredictorTrainer(cfg, device=device)
        state = tr.init_state(0)
        if trees:
            state.load_tree(init)
        else:
            init = state.to_tree()
        state, m = tr.train_step(
            state, {k: v.to(device) for k, v in batch.items()})
        assert bool(m['finite'])
        trees.append(state.to_tree())
    _hold_step(trees[1], trees[0], init, {'model': cfg.lr})


@pytest.mark.cuda
def test_shape_train_step_on_card_matches_cpu(card):
    """One shape-trainer step with every option on, on the card against the
    CPU from the same state, batch and draws, held as _hold_step says."""
    from ctrlhair_tpu_torch.training.shape_trainer import (
        ShapeTrainer, synthetic_batch)
    cfg = C.ShapeConfig(img_size=32, layer_num=3, max_channel=32,
                        hidden_in_channel=8, d_hidden_in_channel=8,
                        face_dim=64, d_hidden_dim=32, kl_free_bits=0.25,
                        lambda_geo=30.0, lambda_info=1.0,
                        disturb_real_batch_mask=True)
    batch = synthetic_batch(torch.Generator().manual_seed(1), cfg, 4)
    trees = []
    for device in ('cpu', 'cuda'):
        tr = ShapeTrainer(cfg, device=device)
        state = tr.init_state(0)
        if trees:
            state.load_tree(init)
        else:
            init = state.to_tree()
        state, m = tr.train_step(
            state, {k: v.to(device) for k, v in batch.items()},
            tr.draws(0, 4))
        assert bool(m['finite']) and 'g/lambda_geo' in m
        trees.append(state.to_tree())
    _hold_step(trees[1], trees[0], init,
               {'gen': cfg.lr_g, 'dis': cfg.lr_d, 'dis_noise': cfg.lr_dz})


@pytest.mark.cuda
def test_bisenet_train_step_on_card_matches_cpu(card):
    """One face-parser step (OHEM on three heads, SGD, batch statistics) on
    the card against the CPU: with the model computing in float64 on both
    devices, every leaf within 1e-4 of its scale (as tests/test_torch_
    bisenet_trainer.py holds it against JAX); in float32, as it trains,
    the card's step and the CPU's within FLOAT32_BAR of the CPU's float64
    step, and the TF32 step outside it."""
    from ctrlhair_tpu_torch.models.layers import set_compute_dtype
    from ctrlhair_tpu_torch.training.bisenet_trainer import BiSeNetTrainer
    cfg = C.BiSeNetConfig(input_size=64)
    g = torch.Generator().manual_seed(4)
    batch = {'image': torch.randn((8, 64, 64, 3), generator=g),
             'label': torch.randint(0, 19, (8, 64, 64), generator=g)}
    init = BiSeNetTrainer(cfg, device='cpu').init_state(0).to_tree()

    def run_step(device, dtype):
        tr = BiSeNetTrainer(cfg, device=device)
        state = tr.init_state(0)
        state.load_tree(init)
        set_compute_dtype(state.model.module, dtype)
        state, m = tr.train_step(
            state, {k: v.to(device) for k, v in batch.items()})
        assert bool(m['finite'])
        return state.to_tree()

    _hold_step(run_step('cuda', torch.float64),
               run_step('cpu', torch.float64), init, {})
    _hold_float32(_float32_against_float64(run_step, init, {}))


@pytest.mark.cuda
def test_landmark_train_step_on_card_matches_cpu(card):
    """One landmark-regressor step on the card against the CPU, held as
    _hold_step says (the conv biases in front of an InstanceNorm have a
    gradient of rounding noise)."""
    from ctrlhair_tpu_torch.data.landmark_dataset import training_batch
    from ctrlhair_tpu_torch.models.landmark_net import LandmarkNetConfig
    from ctrlhair_tpu_torch.training.landmark_trainer import LandmarkTrainer
    cfg = LandmarkNetConfig()
    batch = {k: torch.tensor(v) for k, v in training_batch(
        np.random.default_rng(5), 16).items()}
    trees = []
    for device in ('cpu', 'cuda'):
        tr = LandmarkTrainer(cfg, device=device)
        state = tr.init_state(0)
        if trees:
            state.load_tree(init)
        else:
            init = state.to_tree()
        state, m = tr.train_step(
            state, {k: v.to(device) for k, v in batch.items()})
        assert bool(m['finite'])
        trees.append(state.to_tree())
    _hold_step(trees[1], trees[0], init, {'model': cfg.lr})


@pytest.mark.cuda
def test_warp_pool_on_card_launches_the_kernel(card, tmp_path):
    """generate_warp_pool on the card: one K2 launch per warp, each mask
    equal to the same pair through the host route on >= 99.9% of labels."""
    import os
    from ctrlhair_tpu_torch.data.catalog import DataCatalog
    from ctrlhair_tpu_torch.data.shape_dataset import generate_warp_pool
    from ctrlhair_tpu_torch.ops.landmarks import estimate_landmarks_81
    from ctrlhair_tpu_torch.utils.image import read_png, write_png
    for ds in ('ffhq', 'CelebaMask_HQ'):
        os.makedirs(tmp_path / ds / 'images_256')
        os.makedirs(tmp_path / ds / 'label')
        for i in range(3):
            lab = np.ones((256, 256), np.uint8)
            lab[20 + 8 * i:120, 50:200 - 10 * i] = 13
            lab[120:220, 80:180] = 1
            write_png(str(tmp_path / ds / 'label' / f'{i}.png'), lab)
            write_png(str(tmp_path / ds / 'images_256' / f'{i}.png'),
                      np.zeros((8, 8, 3), np.uint8))
    cat = DataCatalog(str(tmp_path), ['ffhq', 'CelebaMask_HQ'],
                      validity_check=False)
    before = rp.RASTER_UV.launches
    out = str(tmp_path / 'pool')
    assert generate_warp_pool(cat, out, 4, num_threads=2) == 4
    torch.cuda.synchronize()
    assert rp.RASTER_UV.launches == before + 4
    for name in sorted(os.listdir(out)):
        hair_key, face_key = ('___'.join(name.split('___')[:2]),
                              '___'.join(name.split('___')[2:4]))
        # the 256 px labels at the warp's 512 px (nearest: each pixel
        # twice)
        big = [np.asarray(read_png(cat.label_path(k)), np.int32).repeat(
            2, 0).repeat(2, 1) for k in (hair_key, face_key)]
        host = warp.hair_mask_transfer_warp(
            *big, estimate_landmarks_81(big[0]), estimate_landmarks_81(
                big[1]), raster='host')
        assert (read_png(os.path.join(out, name)) == host).mean() >= 0.999


def _sean_trainer(device, remat=False):
    """A small SEAN trainer with every feature on (spectral norm,
    syncbatch, ACE noise, VGG19, lambda_l1) and VGG19 weights seeded on the
    host, the same on every device."""
    from ctrlhair_tpu_torch.models.layers import init_parameters_
    from ctrlhair_tpu_torch.models.sean_discriminator import VGG19Features
    from ctrlhair_tpu_torch.training.sean_trainer import SEANTrainer
    cfg = C.SEANConfig(crop_size=32, ngf=4, zencoder_ngf=4, style_dim=16,
                       num_up_layers=4, num_middle_blocks=1,
                       use_ace_noise=True, remat_blocks=remat)
    vgg = VGG19Features()
    init_parameters_(vgg, torch.Generator().manual_seed(5))
    return SEANTrainer(cfg, vgg_state=vgg.state_dict(), lambda_l1=0.5,
                       dis_ndf=8, dis_n_layers=3, device=device)


@pytest.mark.cuda
def test_sean_train_step_on_card_matches_cpu(card):
    """One SEAN step on the card against the CPU from the same state, batch
    and ACE noise (drawn on the host): with the models computing in float64
    on both devices, held as _hold_step says (the u vectors and the running
    statistics included); in float32, as it trains, the card's step and the
    CPU's within FLOAT32_BAR of the CPU's float64 step, and the TF32 step
    outside it."""
    run_step, init = _sean_step_case()
    _hold_step(run_step('cuda', torch.float64),
               run_step('cpu', torch.float64), init, SEAN_LRS)
    _hold_float32(_float32_against_float64(run_step, init, SEAN_LRS))


SEAN_LRS = {'gen': 1e-4, 'dis': 4e-4}


def _sean_step_case():
    """(run_step, init): run_step(device, dtype) -> the state's tree after
    one step of _sean_trainer from `init` on one batch and one ACE noise
    draw (both made on the host), the models computing in `dtype`."""
    from ctrlhair_tpu_torch.models.layers import set_compute_dtype
    from ctrlhair_tpu_torch.training.sean_trainer import synthetic_batch
    cpu = _sean_trainer('cpu')
    batch = synthetic_batch(np.random.default_rng(6), cpu.cfg, 4)
    noise = cpu.draws(0, 4)
    init = cpu.init_state(0).to_tree()

    def run_step(device, dtype):
        tr = _sean_trainer(device)
        state = tr.init_state(0)
        state.load_tree(init)
        for m in (state.gen.module, state.dis.module, tr.vgg):
            set_compute_dtype(m, dtype)
        state, m = tr.train_step(
            state, {k: v.to(device) for k, v in batch.items()},
            {k: v.to(device) for k, v in noise.items()})
        assert bool(m['finite']) and 'g/vgg' in m and 'g/l1' in m
        return state.to_tree()

    return run_step, init


# The card's float32 SEAN step went off in some steps and processes (4.4e-3
# or 8.9e-3 of a gradient's scale, 5 of 15 steps in one process) while the
# Zencoder's transposed convolution ran its forward with cuDNN's default
# algorithms; see PERF.md.  SEAN_REPEATS steps in one process hold the
# repair, and the same steps with the old forward are printed beside them.
# The bar lies between the repaired steps' readings (1.7e-6 to 2.1e-6, on
# an H100) and the wrong ones, the smaller of which, 4.4e-3, FLOAT32_BAR
# lets through.
SEAN_REPEATS, SEAN_REPEAT_BAR = 10, 1e-4


@pytest.mark.cuda
def test_sean_float32_step_on_card_repeats_within_bar(card, monkeypatch):
    """The float32 SEAN step of test_sean_train_step_on_card_matches_cpu
    taken SEAN_REPEATS times on the card with cuDNN's defaults (TF32 off):
    every one within SEAN_REPEAT_BAR of the CPU's float64 step.  The
    readings of the same steps with the transposed convolution's forward
    as F.conv_transpose2d under cuDNN's defaults (the port before the
    repair) are printed, not held: that fault comes and goes."""
    from ctrlhair_tpu_torch.models import layers
    run_step, init = _sean_step_case()
    ref = run_step('cpu', torch.float64)

    def readings():
        return [_step_distance(run_step('cuda', torch.float32), ref, init,
                               SEAN_LRS)[0] for _ in range(SEAN_REPEATS)]

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    repaired = readings()

    def old_forward(self, x, w, b):
        return torch.nn.functional.conv_transpose2d(
            x, w, b, self.stride, self.padding, self.output_padding)

    monkeypatch.setattr(layers.ConvTranspose, '_transpose', old_forward)
    old = readings()
    print('float32 SEAN steps against float64: repaired', repaired,
          'old forward', old, f'({sum(r > SEAN_REPEAT_BAR for r in old)} of '
          f'{SEAN_REPEATS} above {SEAN_REPEAT_BAR})')
    assert max(repaired) <= SEAN_REPEAT_BAR, repaired


@pytest.mark.cuda
def test_discriminator_input_gradient_on_card_matches_cpu(card):
    """The two-scale PatchGAN's gradient to its input on the card against
    the CPU's in float64, the input built as the SEAN trainer builds it (a
    concatenation of NHWC permutes: channels-last strides), which sends the
    second scale through CUDA's channels-last average pool: within 1e-5 of
    the gradient's largest magnitude.  Beside it, the reading that made the
    discriminator pool a contiguous copy: the same pool's input gradient
    on the channels-last input itself, against the CPU's."""
    from ctrlhair_tpu_torch.models.layers import (
        init_parameters_, set_compute_dtype)
    from ctrlhair_tpu_torch.models.sean_discriminator import (
        MultiscaleDiscriminator)
    from ctrlhair_tpu_torch.utils.masks import label_to_one_hot
    dis = MultiscaleDiscriminator(2, 16, 4, 22)
    init_parameters_(dis, torch.Generator().manual_seed(8))
    rng = np.random.default_rng(8)
    image = rng.uniform(-1, 1, (4, 64, 64, 3))
    label = rng.integers(0, 19, (4, 64, 64))
    grads = []
    for device, dtype in (('cpu', torch.float64), ('cuda', torch.float32)):
        dis.to(device)
        set_compute_dtype(dis, dtype)
        img = torch.tensor(image, dtype=dtype, device=device,
                           requires_grad=True)
        oh = label_to_one_hot(torch.tensor(label, device=device), 19, dtype)
        x = torch.cat([oh.permute(0, 3, 1, 2), img.permute(0, 3, 1, 2)], 1)
        assert x.is_contiguous(memory_format=torch.channels_last)
        loss = sum(f.mean() for scale in dis(x) for f in scale)
        g, = torch.autograd.grad(loss, img)
        grads.append(g.double().cpu())
    err = float((grads[1] - grads[0]).abs().max() / grads[0].abs().max())
    pooled = []
    for device in ('cpu', 'cuda'):
        x = torch.tensor(np.random.default_rng(9).standard_normal(
            (4, 22, 64, 64)), device=device).contiguous(
                memory_format=torch.channels_last).requires_grad_(True)
        y = torch.nn.functional.avg_pool2d(x, 3, 2, 1,
                                           count_include_pad=False)
        w = torch.tensor(np.random.default_rng(10).standard_normal(
            tuple(y.shape)), device=device)
        g, = torch.autograd.grad((y * w).sum(), x)
        pooled.append(g.cpu())
    raw = float((pooled[1] - pooled[0]).abs().max() / pooled[0].abs().max())
    print(f'discriminator input gradient {err:.3g}; a channels-last '
          f'average pool alone {raw:.3g} (float64)')
    assert err <= 1e-5, err


@pytest.mark.cuda
def test_sean_remat_blocks_on_card(card):
    """remat_blocks on the card: the recomputed blocks give the step of
    the plain one (deterministic cuDNN), the running statistics updated
    once."""
    from ctrlhair_tpu_torch.training.sean_trainer import synthetic_batch
    batch = synthetic_batch(np.random.default_rng(7),
                            _sean_trainer('cpu').cfg, 4, 'cuda')
    trees = []
    torch.backends.cudnn.deterministic = True
    try:
        for remat in (False, True):
            tr = _sean_trainer('cuda', remat)
            state = tr.init_state(0)
            if trees:
                state.load_tree(init)
            else:
                init = state.to_tree()
            state, m = tr.train_step(state, batch, tr.draws(0, 4))
            assert bool(m['finite'])
            trees.append(state.to_tree())
    finally:
        torch.backends.cudnn.deterministic = False
    _hold_step(trees[1], trees[0], init, {'gen': 1e-4, 'dis': 4e-4},
               bar=1e-6)


# ChunkRunner on the card (training/chunked.py): the step captured once as
# a CUDA graph and replayed, against the same steps taken eagerly.
def _tiny_shape_case(card, nan_at=None):
    """(trainer, state, make_batch, make_draws) of a tiny shape trainer on
    the card; the batches drawn on the host from the seed and sent through
    pinned memory, a NaN in the face mask of the batch of seed nan_at."""
    from ctrlhair_tpu_torch.training.predictor_trainer import to_device
    from ctrlhair_tpu_torch.training.shape_trainer import (
        ShapeTrainer, synthetic_batch)
    cfg = C.ShapeConfig(img_size=32, layer_num=3, max_channel=32,
                        hidden_in_channel=8, d_hidden_in_channel=8,
                        face_dim=64, d_hidden_dim=32, kl_free_bits=0.25,
                        lambda_geo=30.0, lambda_info=1.0)
    tr = ShapeTrainer(cfg, device=card, seed=3)

    def make_batch(seed):
        batch = synthetic_batch(torch.Generator().manual_seed(seed), cfg, 4)
        if seed == nan_at:
            batch['face'][1, 3, 4, 0] = float('nan')
        return {k: to_device(v, card) for k, v in batch.items()}

    return tr, tr.init_state(0), make_batch, lambda s: tr.draws(s, 4)


def _tiny_landmark_case(card):
    from ctrlhair_tpu_torch.data.landmark_dataset import training_batch
    from ctrlhair_tpu_torch.models.landmark_net import LandmarkNetConfig
    from ctrlhair_tpu_torch.training.landmark_trainer import LandmarkTrainer
    from ctrlhair_tpu_torch.training.predictor_trainer import to_device
    cfg = LandmarkNetConfig(input_size=32, base_channels=4, stages=2,
                            hidden_dim=16)
    tr = LandmarkTrainer(cfg, device=card)

    def make_batch(seed):
        return {k: to_device(torch.tensor(v), card) for k, v in
                training_batch(np.random.default_rng(seed), 8,
                               cfg.input_size).items()}

    return tr, tr.init_state(0), make_batch, None


def _on_card(batch, card):
    from ctrlhair_tpu_torch.training.predictor_trainer import to_device
    return {k: to_device(v, card) for k, v in batch.items()}


def _tiny_ct_case(card):
    """The colour/texture trainer at the tests' tiny config, its step in the
    runner's argument order, the frozen predictors its extra argument."""
    from ctrlhair_tpu_torch.training.color_texture_trainer import (
        ColorTextureTrainer, synthetic_batch)
    cfg = C.ColorTextureConfig(style_dim=64, g_hidden_dim=32,
                               d_hidden_dim=32)
    tr = ColorTextureTrainer(cfg, device=card, seed=3)
    state, preds = tr.init_state(0)

    def step(state, batch, draws, predictors):
        return tr.train_step(state, batch, predictors, draws)

    return (tr, state, lambda seed: _on_card(synthetic_batch(
        torch.Generator().manual_seed(seed), cfg, 8), card),
        lambda s: tr.draws(s, 8), step, (preds,))


def _tiny_predictor_case(card, which):
    import dataclasses
    from ctrlhair_tpu_torch.training.predictor_trainer import (
        PredictorTrainer)
    cfg = C.PredictorConfig(style_dim=64, hidden_dim=32) \
        if which == 'rgb' else dataclasses.replace(
            C.curliness_predictor_config(), style_dim=64, hidden_dim=16)
    tr = PredictorTrainer(cfg, device=card, seed=3)

    def make_batch(seed):
        code = torch.randn((32, 64),
                           generator=torch.Generator().manual_seed(seed))
        batch = {'code': code}
        if which == 'rgb':
            batch.update(rgb_mean=code[:, :3] * 40 + 128,
                         pca_std=code[:, 3:4].abs() * 30 + 20)
        else:
            batch['curliness_label'] = torch.where(
                code[:, :1] + code[:, 1:2] > 0, 1.0, -1.0)
        return _on_card(batch, card)

    return tr, tr.init_state(0), make_batch, lambda s: tr.draws(s, 32)


def _tiny_bisenet_case(card, mesh=None):
    from ctrlhair_tpu_torch.training.bisenet_trainer import BiSeNetTrainer
    cfg = C.BiSeNetConfig(input_size=64, blocks_per_stage=1)
    tr = BiSeNetTrainer(cfg, device=card, mesh=mesh)

    def make_batch(seed):
        g = torch.Generator().manual_seed(seed)
        return _on_card({'image': torch.randn((2, 64, 64, 3), generator=g),
                         'label': torch.randint(0, 19, (2, 64, 64),
                                                generator=g)}, card)

    return tr, tr.init_state(0), make_batch, None


def _tiny_sean_case(card):
    """_sean_trainer's SEAN (spectral norm, ACE noise), its noise drawn by
    the runner's make_draws."""
    from ctrlhair_tpu_torch.training.sean_trainer import synthetic_batch
    tr = _sean_trainer(card)

    def make_batch(seed):
        return synthetic_batch(np.random.default_rng(seed), tr.cfg, 2, card)

    return tr, tr.init_state(0), make_batch, lambda s: tr.draws(s, 2)


def _tiny_case(card, which, nan_at=None):
    """(step, state, make_batch, make_draws, extra args) of one trainer's
    tiny case on the card."""
    if which == 'color_texture':
        tr, state, make_batch, make_draws, step, extra = _tiny_ct_case(card)
        return step, state, make_batch, make_draws, extra
    tr, state, make_batch, make_draws = {
        'shape': lambda: _tiny_shape_case(card, nan_at),
        'landmark': lambda: _tiny_landmark_case(card),
        'rgb': lambda: _tiny_predictor_case(card, 'rgb'),
        'curliness': lambda: _tiny_predictor_case(card, 'curliness'),
        'face_parser': lambda: _tiny_bisenet_case(card),
        'sean': lambda: _tiny_sean_case(card)}[which]()
    return tr.train_step, state, make_batch, make_draws, ()


@pytest.mark.cuda
@pytest.mark.parametrize('which', ['shape', 'landmark', 'color_texture',
                                   'rgb', 'curliness', 'face_parser',
                                   'sean'])
def test_chunked_graph_on_card_equals_eager(card, which):
    """5 steps in chunks of 2 (a remainder of 1) through one captured
    graph against the same 5 steps taken eagerly from the same state, a
    NaN batch at step 3 of the shape trainer: the states bit-identical, the
    step and Adam's counts advanced (the NaN step counts a trip and no
    update), the rows equal.  With deterministic cuDNN, on both sides:
    under cuDNN's defaults two eager runs of the shape steps already
    differ in the last bits (chip_smoke.py's phase (m) prints both gaps)."""
    torch.backends.cudnn.deterministic = True
    try:
        _chunked_against_eager(card, which)
    finally:
        torch.backends.cudnn.deterministic = False


@pytest.mark.cuda
def test_chunked_spans_on_card(card):
    """ChunkRunner's spans on the card, 4 tiny shape steps in chunks of 2:
    train.chunk with its steps, CAPTURE on the first chunk and REPLAY on
    the second, one train.inputs a step inside its chunk; the rows and the
    state bit-identical with the spans recorded and without (deterministic
    cuDNN)."""
    import contextlib
    from ctrlhair_tpu_torch.training.chunked import (
        CAPTURE, REPLAY, ChunkRunner)
    from ctrlhair_tpu_torch.utils import profiling
    torch.backends.cudnn.deterministic = True
    try:
        runs = []
        for record in (True, False):
            step, state, make_batch, make_draws, _ = _tiny_case(card, 'shape')
            runner = ChunkRunner(step, make_batch, make_draws=make_draws)
            profiling.clear()
            with profiling.recording() if record else \
                    contextlib.nullcontext():
                state, rows, _ = runner.run(state, 0, 4, chunk_size=2,
                                            record_every=1)
            spans = [r for r in profiling.records()
                     if r.name.startswith('train.')]
            runs.append((state, rows, spans))
        profiling.clear()
    finally:
        torch.backends.cudnn.deterministic = False
    (state, rows, spans), (plain, plain_rows, none) = runs
    assert not none
    chunks = sorted((r for r in spans if r.name == 'train.chunk'),
                    key=lambda r: r.start_ns)
    assert [c.attrs for c in chunks] == [{'steps': 2, 'graph': CAPTURE},
                                         {'steps': 2, 'graph': REPLAY}]
    for c in chunks:
        inputs = [r for r in spans
                  if r.name == 'train.inputs' and r.parent == c.id]
        assert len(inputs) == 2
        assert all(c.start_ns <= r.start_ns <= r.end_ns <= c.end_ns
                   for r in inputs)
    assert rows == plain_rows
    for a, b in zip(state.tensors(), plain.tensors()):
        assert torch.equal(a, b)


def _chunked_against_eager(card, which, make=None):
    from ctrlhair_tpu_torch.training.chunked import ChunkRunner
    nan_at = 3 if which == 'shape' else None
    make = make or (lambda: _tiny_case(card, which, nan_at))
    step, ref, make_batch, make_draws, extra = make()
    ref_rows = []
    for s in range(5):
        args = () if make_draws is None else (make_draws(s),)
        ref, m = step(ref, make_batch(s), *args, *extra)
        ref_rows.append({k: float(v) for k, v in m.items()})
    step, state, make_batch, make_draws, extra = make()
    runner = ChunkRunner(step, make_batch, make_draws=make_draws)
    seen = []
    state, rows, trips = runner.run(
        state, 0, 5, chunk_size=2, record_every=1, extra_args=extra,
        on_chunk=lambda s, st, rws: seen.append(s))
    assert seen == [2, 4, 5] and runner.captures == 1
    assert trips == (1 if nan_at is not None else 0)
    assert state.step == 5
    parts = state.parts().values() if hasattr(state, 'parts') \
        else [state.model]
    for part in parts:
        if hasattr(part, 'count'):      # Adam's; SGD keeps none
            assert int(part.count) == 5 - trips
    np.testing.assert_array_equal(
        [[r[k] for k in sorted(ref_rows[0])] for r in rows],
        [[r[k] for k in sorted(r)] for r in ref_rows])
    for a, b in zip(state.tensors(), ref.tensors()):
        assert torch.equal(a, b)


def _one_rank_group(card, tmp_path, backend):
    """A one-rank process group on the card over `backend` and its mesh."""
    from ctrlhair_tpu_torch.parallel.mesh import initialize_runtime, make_mesh
    initialize_runtime(card, init_method=f'file://{tmp_path / "store"}',
                       world_size=1, rank=0, backend=backend, timeout=120.0)
    return make_mesh(1, device=card)


@pytest.mark.cuda
def test_chunked_graph_over_one_rank_nccl_group(card, tmp_path):
    """The face parser over a one-rank NCCL group: its collectives (the
    gradient buckets, synced batch norm, the metrics' mean) captured in the
    graph, 5 steps in chunks of 2 bit-identical to the same steps taken
    eagerly through the group (deterministic cuDNN)."""
    import torch.distributed as dist
    mesh = _one_rank_group(card, tmp_path, 'nccl')
    torch.backends.cudnn.deterministic = True
    try:
        def make():
            tr, state, make_batch, _ = _tiny_bisenet_case(card, mesh)
            return tr.train_step, state, make_batch, None, ()

        before = mesh.collectives
        _chunked_against_eager(card, 'face_parser', make)
        assert mesh.collectives > before
    finally:
        torch.backends.cudnn.deterministic = False
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize('backend', ['nccl', None])
def test_chunked_graph_after_eager_steps_over_nccl(card, tmp_path, backend):
    """The face parser over a one-rank NCCL group (and, for comparison,
    without a mesh): 3 eager steps, a copy of the state's tensors taken
    as a caller takes one (clone(), gradients on) and kept, then
    ChunkRunner.run steps 3 to 6 in chunks of 2 from that same state:
    bit-identical to 6 eager steps from the same seed, the copy equal to
    the state after 3 (deterministic cuDNN).

    The copy keeps each parameter's gradient accumulator alive, made on
    the legacy default stream.  Before ChunkRunner gave the state's leaves
    a new autograd identity ahead of the warm-up, the NCCL case failed at
    the capture's end, "CUDA error: operation failed due to a previous
    error during capture" (cudaErrorStreamCaptureInvalidated), after
    torch's warning that an AccumulateGrad node's stream does not match
    its producer's; the case without a mesh passed (NVIDIA H100 80GB HBM3,
    700 W, torch 2.11.0+cu128).  Both pass since, without the warning."""
    import torch.distributed as dist
    from ctrlhair_tpu_torch.training.chunked import ChunkRunner
    mesh = _one_rank_group(card, tmp_path, backend) if backend else None
    k = 3
    torch.backends.cudnn.deterministic = True
    try:
        tr, ref, make_batch, _ = _tiny_bisenet_case(card, mesh)
        for s in range(2 * k):
            if s == k:
                with torch.no_grad():
                    at_k = [t.clone() for t in ref.tensors()]
            ref, _ = tr.train_step(ref, make_batch(s))
        tr, state, make_batch, _ = _tiny_bisenet_case(card, mesh)
        for s in range(k):
            state, _ = tr.train_step(state, make_batch(s))
        copy = [t.clone() for t in state.tensors()]
        assert any(c.grad_fn is not None for c in copy)
        runner = ChunkRunner(tr.train_step, make_batch)
        state, rows, trips = runner.run(state, k, 2 * k, chunk_size=2,
                                        record_every=1)
        assert runner.captures == 1 and trips == 0
        assert state.step == 2 * k and [r['step'] for r in rows] == [3, 4, 5]
        for a, b in zip(state.tensors(), ref.tensors()):
            assert torch.equal(a, b)
        for a, b in zip(copy, at_k):
            assert torch.equal(a, b)
    finally:
        torch.backends.cudnn.deterministic = False
        if backend:
            dist.destroy_process_group()


@pytest.mark.cuda
def test_chunked_refuses_a_gloo_mesh_on_card(card, tmp_path):
    """gloo's collectives run on the host and cannot be captured: on the
    card a trainer over a gloo mesh is refused before any step, its step
    bound or wrapped."""
    import functools
    import torch.distributed as dist
    from ctrlhair_tpu_torch.training.chunked import ChunkRunner
    mesh = _one_rank_group(card, tmp_path, 'gloo')
    try:
        tr, state, make_batch, _ = _tiny_bisenet_case(card, mesh)
        for step in (tr.train_step, functools.partial(tr.train_step)):
            with pytest.raises(ValueError, match='gloo'):
                ChunkRunner(step, make_batch).run(state, 0, 2, chunk_size=2)
        assert state.step == 0
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_chunked_graph_capture_failure_raises(card):
    """A step that reads a value on the host cannot be captured: run raises
    the capture's error (no eager fall-back) and leaves the state where it
    was."""
    from ctrlhair_tpu_torch.training.chunked import ChunkRunner
    tr, state, make_batch, make_draws = _tiny_shape_case(card)
    before = [t.clone() for t in state.tensors()]

    def host_read_step(st, batch, draws):
        st, m = tr.train_step(st, batch, draws)
        float(m['g_total'])
        return st, m

    runner = ChunkRunner(host_read_step, make_batch, make_draws=make_draws)
    with pytest.raises(RuntimeError):
        runner.run(state, 0, 2, chunk_size=2)
    assert state.step == 0 and runner.captures == 0
    torch.cuda.synchronize()
    for a, b in zip(state.tensors(), before):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_conv_transpose_on_card_takes_deterministic_algorithms(card):
    """The port's ConvTranspose on a CUDA tensor runs its forward with
    cuDNN's deterministic algorithms whatever the global setting (with the
    default ones the float32 SEAN step, whose Zencoder has one, went off in
    some steps): with cuDNN's defaults its output equals
    F.conv_transpose2d's under deterministic cuDNN bit for bit, and the
    output and the input and weight gradients stand within 1e-5 of the
    CPU's float64."""
    from ctrlhair_tpu_torch.models.layers import (
        TorchConvTranspose, init_parameters_, set_compute_dtype)
    up = TorchConvTranspose(16, 32, 3, 2, 1, 1)
    init_parameters_(up, torch.Generator().manual_seed(9))
    x0 = torch.tensor(np.random.default_rng(9).standard_normal(
        (4, 16, 32, 32)), dtype=torch.float32)
    runs = []
    for device, dtype in (('cpu', torch.float64), ('cuda', torch.float32)):
        up.to(device=device, dtype=dtype)
        set_compute_dtype(up, dtype)
        x = x0.to(device=device, dtype=dtype).requires_grad_(True)
        y = up(x)
        gx, gw = torch.autograd.grad((y * y).sum(), (x, up.conv.weight))
        runs.append([t.detach() for t in (y, gx, gw)])
    torch.backends.cudnn.deterministic = True
    try:
        conv = up.conv
        with torch.no_grad():
            y = torch.nn.functional.conv_transpose2d(
                x0.to(card), conv.weight, conv.bias, conv.stride,
                conv.padding, conv.output_padding)
    finally:
        torch.backends.cudnn.deterministic = False
    assert torch.equal(runs[1][0], y)
    for got, ref in zip(runs[1], runs[0]):
        scale = float(ref.abs().max())
        assert float((got.double().cpu() - ref).abs().max()) <= 1e-5 * scale


class _StyleWgradState:
    """A ChunkRunner state: the folded kernel and the gradient last taken."""

    def __init__(self, folded):
        self.step = 0
        self.folded = folded
        self.grad = torch.zeros_like(folded)

    def tensors(self):
        return [self.folded, self.grad]


@pytest.mark.cuda
def test_style_conv_weight_gradient_on_card(card):
    """The folded style conv's weight gradient (models/sean._StyleConv) at
    up_2's widths (N=4, C=256, 128x128, float32, TF32 off): within 1e-5 of
    a float64 reference, bit-identical over two runs, equal inside
    ChunkRunner's capture and replay and eagerly, and its backward launches
    no cuDNN FFT kernel (cf32 GEMM or fft2d)."""
    from torch.profiler import ProfilerActivity, profile
    from ctrlhair_tpu_torch.models.sean import _StyleConv
    from ctrlhair_tpu_torch.training.chunked import ChunkRunner
    from ctrlhair_tpu_torch.utils.masks import label_to_one_hot
    n, c, r, s = 4, 256, 19, 128
    gen = torch.Generator(device=card).manual_seed(20)

    def batch(step):
        g = torch.Generator(device=card).manual_seed(100 + step)
        lab = torch.randint(0, r, (n, s, s), generator=g, device=card)
        return {'seg': label_to_one_hot(lab, r).permute(0, 3, 1, 2),
                'go': torch.randn((n, c, s, s), generator=g, device=card)}

    def wgrad(folded, b):
        y = _StyleConv.apply(b['seg'], folded)
        return torch.autograd.grad(y, folded, b['go'])[0]

    folded = torch.randn((n, c, r, 3, 3), generator=gen, device=card,
                         requires_grad=True)
    b0 = batch(0)
    got = wgrad(folded, b0)
    assert torch.equal(got, wgrad(folded, b0))
    cols = torch.nn.functional.unfold(b0['seg'].double(), 3, padding=1)
    ref = torch.einsum('nchw,nkhw->nck', b0['go'].double(),
                       cols.view(n, r * 9, s, s)).view(n, c, r, 3, 3)
    scale = float(ref.abs().max())
    assert float((got.double() - ref).abs().max()) <= 1e-5 * scale

    def step(state, b):
        state.grad.copy_(wgrad(state.folded, b))
        state.step += 1
        return state, {'sum': state.grad.sum()}

    state = _StyleWgradState(folded)
    runner = ChunkRunner(step, batch)
    for k in range(3):
        state, _, _ = runner.run(state, k, k + 1, chunk_size=1)
        assert torch.equal(state.grad, wgrad(state.folded, batch(k)))
    assert runner.captures == 1

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wgrad(folded, b0)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert names
    assert not [k for k in names if 'cf32' in k or 'fft2d' in k.lower()]


class _ConvSplitState:
    """A ChunkRunner state: a Conv and its output and gradients last taken."""

    def __init__(self, conv, like):
        self.step = 0
        self.conv = conv
        self.out = [torch.zeros_like(t) for t in like]

    def tensors(self):
        return self.out


@pytest.mark.cuda
@pytest.mark.parametrize('n,cin,cout,s,axis,deterministic', [
    (4, 256, 128, 128, 'out', False),   # up_2.conv_0: its forward took FFT
    (4, 1024, 512, 32, 'in', True)])    # up_0.conv_0: its data gradient did
def test_conv_split_at_sean_widths_on_card(card, n, cin, cout, s, axis,
                                           deterministic):
    """A float32 SEAN conv through Conv (TF32 off): routed to conv_split
    over the listed halves, one `conv_split` span a call, its forward, data
    gradient and weight gradient within 1e-5 of float64, no cuDNN FFT
    kernel (cf32 GEMM or fft2d) in forward or backward and both under 30
    ms (cuDNN's FFT forward alone took 271 to 391 ms at up_2.conv_0's
    shape); then bit-identical over two runs and equal inside ChunkRunner's
    capture and replay and eagerly, no span at a replay.  The data
    gradients of up_0.conv_0's halves over its input channels take an
    algorithm of cuDNN's whose bits do not repeat by default (neither did
    up_2.conv_0's whole data gradient on an H100), so their bits are held
    with cuDNN's deterministic algorithms."""
    from torch.profiler import ProfilerActivity, profile
    from ctrlhair_tpu_torch.models.layers import Conv, split_axis
    from ctrlhair_tpu_torch.training.chunked import ChunkRunner
    from ctrlhair_tpu_torch.utils import profiling
    conv = Conv(cin, cout, 3, 1, 1).to(card)
    conv.reset_parameters(torch.Generator(device=card).manual_seed(22))
    with torch.no_grad():
        conv.bias.uniform_(-1, 1)

    def batch(step):
        # nonnegative inputs and output gradients: the weight gradient is
        # a sum of n*s*s products without cancellation, so the bar holds
        # the arithmetic, not the data's conditioning
        g = torch.Generator(device=card).manual_seed(200 + step)
        return {'x': torch.rand((n, cin, s, s), generator=g, device=card),
                'go': torch.rand((n, cout, s, s), generator=g, device=card)}

    def passes(b):
        x = b['x'].detach().requires_grad_(True)
        y = conv(x)
        gx, gw, gb = torch.autograd.grad(y, (x, conv.weight, conv.bias),
                                         b['go'])
        return y.detach(), gx, gw, gb

    b0 = batch(0)
    assert split_axis(b0['x'].shape, conv.weight.shape, conv.stride,
                      torch.float32, torch.backends.cudnn.is_acceptable(
                          b0['x']), False) == axis
    profiling.clear()
    with profiling.recording():
        got = passes(b0)
    spans = [r.attrs for r in profiling.records() if r.name == 'conv_split']
    profiling.clear()
    assert spans == [{'n': n, 'cin': cin, 'cout': cout, 'hw': s * s,
                      'parts': 2}]

    xd = b0['x'].double().requires_grad_(True)
    wd, bd = (p.detach().double().requires_grad_(True)
              for p in (conv.weight, conv.bias))
    yd = torch.nn.functional.conv2d(xd, wd, bd, 1, 1)
    ref = (yd.detach(),) + torch.autograd.grad(yd, (xd, wd, bd),
                                               b0['go'].double())
    for name, a, r in zip(('forward', 'data', 'weight', 'bias'), got, ref):
        scale = float(r.abs().max())
        assert float((a.double() - r).abs().max()) <= 1e-5 * scale, name

    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        e0.record()
        passes(b0)
        e1.record()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert names
    assert not [k for k in names if 'cf32' in k or 'fft2d' in k.lower()]
    assert e0.elapsed_time(e1) < 30.0

    def step(state, b):
        for slot, t in zip(state.out, passes(b)):
            slot.copy_(t)
        state.step += 1
        return state, {'sum': state.out[0].sum()}

    torch.backends.cudnn.deterministic = deterministic
    try:
        got = passes(b0)
        for a, c in zip(got, passes(b0)):
            assert torch.equal(a, c)
        state = _ConvSplitState(conv, got)
        runner = ChunkRunner(step, batch)
        for k in range(3):
            with profiling.recording():
                state, _, _ = runner.run(state, k, k + 1, chunk_size=1)
            routed = [r for r in profiling.records()
                      if r.name == 'conv_split']
            profiling.clear()
            assert bool(routed) == (k == 0)
            for a, c in zip(state.out, passes(batch(k))):
                assert torch.equal(a, c)
        assert runner.captures == 1
    finally:
        torch.backends.cudnn.deterministic = False


# ------------------------------------------------ the render's CUDA graphs
@pytest.fixture(scope='module')
def full_editor():
    """The full-width editor (PipelineConfig(): bfloat16 SEAN at 256 px),
    one for the module's render-graph tests."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return HairEditor(C.PipelineConfig(), device='cuda', seed=1)


def render_case(editor, n, seed, expand=False):
    """(codes, label, latent) of a batch of n on the card, seeded; expand:
    codes and label as one row expanded to n, as output_sweep passes
    them."""
    from ctrlhair_tpu_torch.constants import NUM_CLASSES
    from ctrlhair_tpu_torch.pipeline.latent import Latent
    cfg, dev = editor.cfg, editor.device
    g = torch.Generator(device=dev).manual_seed(seed)
    rows = 1 if expand else n
    codes = torch.randn(rows, NUM_CLASSES, cfg.sean.style_dim, generator=g,
                        device=dev)
    label = torch.randint(0, NUM_CLASSES, (rows,) + (cfg.edit_size,) * 2,
                          generator=g, device=dev, dtype=torch.int32)
    if expand:
        codes, label = codes.expand(n, -1, -1), label.expand(n, -1, -1)
    r = lambda d: torch.randn(n, d, generator=g, device=dev)
    lat = Latent(hsv=torch.rand(n, 3, generator=g, device=dev) * 170,
                 pca_std=r(1).abs(), curliness=r(
                     cfg.color_texture.curliness_dim),
                 texture=r(cfg.color_texture.noise_dim),
                 shape=r(cfg.shape.hair_dim), face=r(cfg.shape.face_dim))
    return codes, label, lat


def graph_modes(editor, fn):
    """fn() under profiling.recording() -> (its result, the `graph`
    attribute of each render span it opened)."""
    from ctrlhair_tpu_torch.utils import profiling
    profiling.clear()
    with profiling.recording():
        out = fn()
    modes = [r.attrs['graph'] for r in profiling.records()
             if r.name == 'render']
    profiling.clear()
    return out, modes


def eager_render(editor, codes, label, lat):
    from ctrlhair_tpu_torch.pipeline.editor import _FEATURE_FIELDS
    with torch.inference_mode():
        return editor._edit_render_body(
            codes, label, *(getattr(lat, f) for f in _FEATURE_FIELDS))


@pytest.mark.cuda
@pytest.mark.parametrize('n,expand', [(1, False), (8, True)])
def test_render_graph_replay_equals_eager(card, full_editor, n, expand):
    """At batch 1, and at batch 8 from expanded codes and label: the
    eager first call, the capture's replay and later replays (other inputs
    too) are the eager render bit for bit."""
    ed = full_editor
    ed._render_graphs.clear()
    for step, seed in enumerate((1, 1, 1, 2, 3)):
        codes, label, lat = render_case(ed, n, seed, expand)
        got, modes = graph_modes(ed, lambda: ed.edit_render(codes, label,
                                                            lat))
        assert modes == [(0, 2, 1, 1, 1)[step]]
        assert torch.equal(got, eager_render(ed, codes, label, lat))


@pytest.mark.cuda
def test_output_after_replay_equals_eager(card, full_editor):
    """The full output (render, then the blend with K1) through the
    render's replay equals the output with the render run eagerly."""
    ed = full_editor
    ed._render_graphs.clear()
    codes, label, lat = render_case(ed, 1, 4)
    target = render_case(ed, 1, 5)[1]
    face = torch.randint(0, 256, (1, 256, 256, 3), dtype=torch.uint8,
                         generator=torch.Generator(device=card).manual_seed(6),
                         device=card)
    outs, modes = graph_modes(ed, lambda: [
        ed.output(codes, lat, face, label, target) for _ in range(3)])
    assert modes == [0, 2, 1]
    ed._render_graphs.enabled = False
    try:
        want = ed.output(codes, lat, face, label, target)
    finally:
        ed._render_graphs.enabled = True
    for got in outs:
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_render_replay_follows_loaded_weights(card, full_editor):
    """load_state_dict copies in place: the graph captured under one set of
    weights replays under fresh ones and equals their eager render."""
    ed = full_editor
    ed._render_graphs.clear()
    saved = {k: v.clone() for k, v in ed.state_dict().items()}
    codes, label, lat = render_case(ed, 1, 7)
    try:
        first, modes = graph_modes(ed, lambda: [
            ed.edit_render(codes, label, lat) for _ in range(3)])
        assert modes == [0, 2, 1]
        fresh = HairEditor(ed.cfg, device=card, seed=2).state_dict()
        ed.load_state_dict(fresh)
        del fresh
        got, modes = graph_modes(ed, lambda: ed.edit_render(codes, label,
                                                            lat))
        assert modes == [1] and ed._render_graphs.captures >= 1
        want = eager_render(ed, codes, label, lat)
        assert torch.equal(got, want) and not torch.equal(got, first[-1])
    finally:
        ed.load_state_dict(saved)


@pytest.mark.cuda
def test_render_replays_do_not_alias(card, full_editor):
    """Two consecutive replays hand back two tensors: the first keeps its
    values when the second is rendered from other inputs."""
    ed = full_editor
    ed._render_graphs.clear()
    a_in, b_in = render_case(ed, 1, 8), render_case(ed, 1, 9)
    for _ in range(2):
        ed.edit_render(*a_in)
    a = ed.edit_render(*a_in)
    a_copy = a.clone()
    b, modes = graph_modes(ed, lambda: ed.edit_render(*b_in))
    assert modes == [1]
    assert a.data_ptr() != b.data_ptr()
    assert torch.equal(a, a_copy) and not torch.equal(a, b)
    assert torch.equal(b, eager_render(ed, *b_in))


@pytest.mark.cuda
def test_warm_thread_captures_while_the_caller_renders(card, monkeypatch):
    """HairEditor(warm_batches=(1,)) warms, and captures, on a daemon
    thread while this thread renders and outputs at batch 1: no error on
    either thread, and every image equals the eager one."""
    import threading
    errors = []
    monkeypatch.setattr(threading, 'excepthook',
                        lambda args: errors.append(args.exc_value))
    ed = HairEditor(C.PipelineConfig(), device=card, seed=1,
                    warm_batches=(1,))
    cases = [render_case(ed, 1, 20 + i) for i in range(6)]
    face = torch.zeros((1, 256, 256, 3), dtype=torch.uint8, device=card)
    got = []
    for _ in range(4):
        for codes, label, lat in cases:
            got.append((ed.edit_render(codes, label, lat), codes, label,
                        lat))
            ed.output(codes, lat, face, label, label)
    ed.join_warm()
    torch.cuda.synchronize()
    assert errors == []
    assert ed._render_graphs.captures >= 1
    for img, codes, label, lat in got:
        assert torch.equal(img, eager_render(ed, codes, label, lat))


@pytest.mark.cuda
def test_render_replay_kernels_lie_in_the_render_span(card, full_editor):
    """Under torch.profiler the replay's kernels are recorded one by one,
    each launched (cudaGraphLaunch) inside the program's render span: as
    many as the eager render's, give or take the input slots' copies."""
    from torch.profiler import ProfilerActivity, profile
    ed = full_editor
    ed._render_graphs.clear()
    case = render_case(ed, 1, 10)

    def kernels_in_render(call):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        spans, launch, kernels = [], {}, []
        for e in prof.profiler.kineto_results.events():
            if e.device_type() != torch.autograd.DeviceType.CPU:
                if not e.is_user_annotation() and not e.name().startswith(
                        ('Memcpy', 'Memset')):
                    kernels.append(e.correlation_id())
            elif e.is_user_annotation():
                if e.name() == 'ctrlhair.render':
                    spans.append((e.start_ns(),
                                  e.start_ns() + e.duration_ns()))
            elif e.name().startswith('cu'):
                launch[e.correlation_id()] = (e.name(), e.start_ns())
        assert len(spans) == 1
        inside = [launch[c] for c in kernels if c in launch
                  and spans[0][0] <= launch[c][1] <= spans[0][1]]
        return len(kernels), inside

    n_eager, inside = kernels_in_render(lambda: ed.edit_render(*case))
    assert n_eager > 100 and len(inside) == n_eager
    ed.edit_render(*case)                           # the capture
    n_replay, inside = kernels_in_render(lambda: ed.edit_render(*case))
    assert len(inside) == n_replay
    assert {name for name, _ in inside} & {'cudaGraphLaunch',
                                           'cuGraphLaunch'}
    assert abs(n_replay - n_eager) <= 7, (n_replay, n_eager)
