# The port's data parallelism (ctrlhair_tpu_torch/parallel/mesh.py, the
# synced BatchNorm of models/layers.py, the global-batch loss terms of
# training/) on W = 2 and W = 4 gloo ranks on the CPU: the counterparts of
# tests/test_syncbn.py and tests/test_multichip_inference.py, and one test
# for each loss term that the trainers compute from global sums.
#
# The ranks are spawned processes (parallel.dryrun.run_on_ranks) that meet
# through a file:// store in a temporary directory, each on one torch
# thread, joined within a deadline; their code is tests/torch_parallel_
# ranks.py, which the single-process references here run too, with mesh
# None on the whole batch.  Both groups of ranks run once for the module,
# beside the JAX programs they are held to (shard_map over make_mesh(W),
# jit-compiled once each).
#
# Bars: against the single process on the whole batch, 1e-6 of each
# array's largest magnitude (max(1, |max|)), values and gradients; against
# JAX's shard_map, and BiSeNet's train-mode forward against the single
# process too, JAX's own bars (2e-4, running statistics 2e-5).
import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from conftest import tiny_pipeline_cfg
from ctrlhair_tpu.config import BiSeNetConfig as JaxBiSeNetConfig
from ctrlhair_tpu.models.bisenet import BiSeNet as JaxBiSeNet
from ctrlhair_tpu.models.layers import BatchNorm as JaxBatchNorm
from ctrlhair_tpu.parallel.mesh import make_mesh as jax_make_mesh
from ctrlhair_tpu_torch import config as cfg_mod
from ctrlhair_tpu_torch.constants import HAIR_IDX
from ctrlhair_tpu_torch.convert import to_flax
from ctrlhair_tpu_torch.models.bisenet import BiSeNet
from ctrlhair_tpu_torch.models.layers import (
    RunningBatchNorm, init_parameters_, set_sync)
from ctrlhair_tpu_torch.models.sean import SEAN
from ctrlhair_tpu_torch.parallel import mesh as pmesh
from ctrlhair_tpu_torch.parallel.dryrun import run_on_ranks
from ctrlhair_tpu_torch.pipeline.latent import Latent
from ctrlhair_tpu_torch.training import losses as L
from ctrlhair_tpu_torch.training.color_texture_trainer import (
    ColorTextureTrainer)
from test_torch_convert import port_config
import torch_parallel_ranks as ranks

WORLDS = (2, 4)
BAR = 1e-6
BISENET_CFG = dict(input_size=32, blocks_per_stage=1)
LOSS_CASES = ('kl_loss_free_bits', 'moment_1', 'moment_2', 'masked_mean',
              'weighted_bce', 'rec_img_hair_mse')


def close(got, ref, bar=BAR, what=''):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, what
    scale = max(1.0, float(np.abs(ref).max())) if ref.size else 1.0
    np.testing.assert_allclose(got, ref, rtol=0, atol=bar * scale,
                               err_msg=what)


def payload():
    """The inputs of every case, from seeded numpy generators; weights
    drawn by the port's initialisers from seeded generators."""
    rng = np.random.default_rng(7)
    bn_x = rng.standard_normal((16, 3, 4, 4)).astype(np.float32)
    cfg = cfg_mod.BiSeNetConfig(**BISENET_CFG)
    model = BiSeNet(cfg, train=True)
    init_parameters_(model, torch.Generator().manual_seed(0))
    sean_cfg = dict(crop_size=32, ngf=2, zencoder_ngf=2, style_dim=16)
    sean = SEAN(cfg_mod.SEANConfig(**sean_cfg))
    init_parameters_(sean, torch.Generator().manual_seed(1))
    n = 8
    label = rng.integers(0, 19, (n, 32, 32)).astype(np.int32)
    label[:, 4:14, 6:26] = HAIR_IDX
    losses = {
        'A': rng.standard_normal((6, 4)).astype(np.float32) * 0.5,
        'B': rng.standard_normal((6, 4)).astype(np.float32) * 0.5,
        'C': rng.standard_normal((5, 16)).astype(np.float32) * 0.5,
        'free_bits': 0.3,
        'batch': {
            'x': rng.standard_normal((n, 6)).astype(np.float32),
            'mask': rng.integers(0, 2, (n, 4)).astype(np.int32),
            'target': rng.integers(0, 2, (n, 1)).astype(np.float32),
            'weight': np.abs(rng.standard_normal((n, 1))).astype(
                np.float32) + 0.1,
            'noise': rng.standard_normal((n, 4)).astype(np.float32),
            'code': rng.standard_normal((n, 5)).astype(np.float32),
            'sean_code': rng.standard_normal((n, 19, 16)).astype(
                np.float32),
            'label': label,
            'image': (rng.uniform(-1, 1, (n, 32, 32, 3))).astype(
                np.float32)},
        'p3': rng.permutation(n), 'use_enc': True,
        'ct_cfg': dict(style_dim=16), 'rec_img_subset': 3,
        'sean_cfg': sean_cfg,
        'sean_state': {k: v.numpy() for k, v in sean.state_dict().items()}}
    editor_cfg = port_config(tiny_pipeline_cfg())
    z = Latent.zeros(n)
    s = editor_cfg.edit_size
    edit_inputs = {
        'codes': rng.standard_normal(
            (n, 19, editor_cfg.sean.style_dim)).astype(np.float32) * 0.5,
        'label': rng.integers(0, 19, (n, s, s)).astype(np.int32),
        'hsv': rng.uniform(0, 255, (n, 3)).astype(np.float32),
        'pca_std': rng.uniform(20, 120, (n, 1)).astype(np.float32),
        **{k: rng.standard_normal(tuple(getattr(z, k).shape)).astype(
            np.float32) for k in ('curliness', 'texture', 'shape', 'face')}}
    return {'bn_x': bn_x,
            'bn_x_shifted': bn_x + np.arange(16, dtype=np.float32)[
                :, None, None, None],
            'bisenet_cfg': cfg,
            'bisenet_state': {k: v.numpy()
                              for k, v in model.state_dict().items()},
            'bisenet_x': rng.standard_normal((n, 32, 32, 3)).astype(
                np.float32),
            'losses': losses, 'editor_cfg': editor_cfg,
            'edit_inputs': edit_inputs}


def jax_shard_map(fn, world, x):
    """jit(shard_map(fn)) over make_mesh(world): x sharded over 'dp', the
    outputs (rows, then a replicated rest)."""
    from jax.experimental.shard_map import shard_map
    mesh = jax_make_mesh(world, tp=1)
    mapped = jax.jit(shard_map(fn, mesh=mesh, in_specs=P('dp'),
                               out_specs=(P('dp'), P()), check_rep=False))
    with mesh:
        return jax.device_get(mapped(jnp.asarray(x)))


def jax_results(data):
    """JAX's BatchNorm(axis_name='dp') and BiSeNet(train=True,
    axis_name='dp') under shard_map, on each world size."""
    bn_vars = JaxBatchNorm(use_running_average=False, affine=False).init(
        jax.random.PRNGKey(0), jnp.asarray(data['bn_x'][:1].transpose(
            0, 2, 3, 1)))
    model = BiSeNet(data['bisenet_cfg'], train=True)
    model.load_state_dict({k: torch.tensor(v) for k, v in
                           data['bisenet_state'].items()})
    variables = to_flax(model, 'bisenet')
    jcfg = JaxBiSeNetConfig(**BISENET_CFG)
    out = {}
    for world in WORLDS:
        sync_bn = JaxBatchNorm(use_running_average=False, affine=False,
                               axis_name='dp')
        synced = JaxBiSeNet(jcfg, train=True, axis_name='dp')
        out[world] = {
            'sync_bn': jax_shard_map(
                lambda xs: sync_bn.apply(bn_vars, xs,
                                         mutable=['batch_stats']),
                world, data['bn_x'].transpose(0, 2, 3, 1)),
            'bisenet': jax_shard_map(
                lambda xs: synced.apply(variables, xs,
                                        mutable=['batch_stats']),
                world, data['bisenet_x'])}
    return out


@pytest.fixture(scope='module')
def run():
    """The ranks of both world sizes (in two threads, beside JAX's
    programs in this one), the single-process references and JAX's."""
    data = payload()
    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as pool:
        futures = {w: pool.submit(run_on_ranks, ranks.parallel_checks, w,
                                  data, deadline_s=240.0)
                   for w in WORLDS}
        jax_out = jax_results(data)
        single = ranks.parallel_checks(None, data)
        got = {w: f.result() for w, f in futures.items()}
    return {'data': data, 'ranks': got, 'single': single, 'jax': jax_out}


def gathered(per_rank, key, index=0):
    return np.concatenate([r[key][index] for r in per_rank])


@pytest.mark.parametrize('world', WORLDS)
def test_sync_bn_matches_global_batch_norm(run, world):
    """The synced RunningBatchNorm on W ranks normalises each rank's rows
    with the global batch's statistics, and every rank's running
    statistics are the global batch's; JAX's BatchNorm(axis_name='dp')
    under shard_map gives the same."""
    per_rank, single = run['ranks'][world], run['single']['sync_bn']
    close(gathered(per_rank, 'sync_bn'), single[0], what='output')
    for r in per_rank:
        for i, name in ((1, 'mean'), (2, 'var')):
            close(r['sync_bn'][i], single[i], what=name)
    jax_out, jax_stats = run['jax'][world]['sync_bn']
    close(gathered(per_rank, 'sync_bn').transpose(0, 2, 3, 1), jax_out,
          2e-4, 'against JAX')
    stats = jax_stats['batch_stats']['bn']
    close(per_rank[0]['sync_bn'][1], stats['mean'], 2e-5)
    close(per_rank[0]['sync_bn'][2], stats['var'], 2e-5)


@pytest.mark.parametrize('world', WORLDS)
def test_local_bn_differs_from_global(run, world):
    """Sanity: without the collective each shard's statistics differ from
    the global ones (samples shifted by their index), and with it they do
    not."""
    x = run['data']['bn_x_shifted']
    bn = RunningBatchNorm(3, affine=False, train=True)
    local = np.concatenate([bn(torch.from_numpy(part)).numpy()
                            for part in np.split(x, world)])
    glob = run['single']['sync_bn_shifted'][0]
    assert np.abs(local - glob).max() > 0.1
    close(gathered(run['ranks'][world], 'sync_bn_shifted'), glob)


@pytest.mark.parametrize('world', WORLDS)
def test_bisenet_sync_bn_on_ranks(run, world):
    """BiSeNet(train=True) with synced BatchNorm on W ranks equals the
    whole batch in one process, its running statistics too, and JAX's
    BiSeNet(axis_name='dp') under shard_map on the same weights, at JAX's
    bars (the attention maps' BatchNorm over [N,1,1,C] cancels
    catastrophically in float32: the two ways of summing the batch stand
    about 5e-6 of the logits' scale apart)."""
    per_rank = run['ranks'][world]
    single_out, single_stats = run['single']['bisenet']
    got = gathered(per_rank, 'bisenet')
    close(got, single_out, 2e-4, 'logits')
    for r in per_rank:
        for k, v in r['bisenet'][1].items():
            close(v, single_stats[k], 2e-5, k)
    jax_out, jax_mut = run['jax'][world]['bisenet']
    close(got, jax_out, 2e-4, 'logits against JAX')
    model = BiSeNet(run['data']['bisenet_cfg'], train=True)
    stats = to_flax(model, 'bisenet', {
        k: torch.tensor(v) for k, v in per_rank[0]['bisenet'][1].items()})
    got_leaves = jax.tree_util.tree_flatten_with_path(
        stats['batch_stats'])[0]
    want = jax.tree_util.tree_leaves(jax_mut['batch_stats'])
    assert len(got_leaves) == len(want)
    for (path, a), b in zip(got_leaves, want):
        close(a, b, 2e-5, jax.tree_util.keystr(path))


@pytest.mark.parametrize('world', WORLDS)
@pytest.mark.parametrize('name', LOSS_CASES)
def test_global_batch_loss_on_ranks(run, world, name):
    """Each loss term that the trainers compute from global sums: its value
    on every rank (the weighted BCE, a per-sample mean under a global
    normaliser: the mean of the ranks' values), and the gradient of
    replicated parameters averaged over the ranks (as the trainers reduce
    them), equal the single process's on the global batch."""
    value, grads = run['single']['losses'][name]
    values = [r['losses'][name][0] for r in run['ranks'][world]]
    close(np.mean(values), value, what='value')
    if name != 'weighted_bce':
        assert len(set(values)) == 1
    for r in run['ranks'][world]:
        got_value, got_grads = r['losses'][name]
        assert len(got_grads) == len(grads)
        for g, ref in zip(got_grads, grads):
            assert np.abs(ref).max() > 0
            close(g, ref, what='gradient')


@pytest.mark.parametrize('world', WORLDS)
def test_shuffled_condition_gather(run, world):
    """The colour/texture step's p3 pass: each rank indexes the encoder
    noise gathered from every rank by its rows of the global permutation;
    over the ranks that is the global batch's noise permuted, bit for bit,
    and no gradient flows through it."""
    data = run['data']['losses']
    ref, _ = run['single']['losses']['p3']
    for r in run['ranks'][world]:
        got, needs_grad = r['losses']['p3']
        np.testing.assert_array_equal(got, ref)
        assert not needs_grad
    z = data['batch']['x'] @ data['A']
    close(ref, z[data['p3']])


@pytest.mark.parametrize('world', WORLDS)
def test_sharded_edit_render_matches_whole_batch(run, world):
    """The tiny editor's edit_render of each rank's rows, gathered over the
    ranks, equals the whole batch rendered in one process."""
    for r in run['ranks'][world]:
        close(r['edit_render'], run['single']['edit_render'], 1e-5)


def test_shard_batch_rows_and_refusal():
    """shard_batch takes a rank's contiguous rows and keeps 0-d entries;
    a batch that does not split over the ranks is refused, as JAX's
    sharding refuses it."""
    mesh = pmesh.Mesh(group=None, rank=1, world=3, device=torch.device('cpu'))
    batch = {'x': torch.arange(12).reshape(6, 2), 'coin': torch.tensor(True)}
    rows = pmesh.shard_batch(batch, mesh)
    assert rows['x'].tolist() == [[4, 5], [6, 7]]
    assert rows['coin'] is batch['coin']
    assert pmesh.shard_batch(batch, None) is batch
    with pytest.raises(ValueError, match='does not split'):
        pmesh.shard_batch({'x': torch.zeros(7, 2)}, mesh)


def test_helpers_without_a_process_group():
    """mesh None is one process: every helper is the identity; make_mesh
    refuses a device count that tp does not divide, as JAX's does, and
    needs a process group."""
    x = torch.randn(4, 3)
    assert pmesh.global_sum(x, None) is x
    assert pmesh.all_gather_rows(x, None) is x
    assert pmesh.local_rows(x, None) is x
    grads = [x, x * 2]
    assert all(a is b for a, b in zip(pmesh.all_reduce_grads(grads, None),
                                      grads))
    assert torch.equal(pmesh.batch_mean(x, None), x.mean(0))
    with pytest.raises(ValueError, match='not divisible by tp=2'):
        pmesh.make_mesh(3, tp=2)
    with pytest.raises(RuntimeError, match='initialize_runtime'):
        pmesh.make_mesh(2)


def test_no_batch_norm_under_a_penalty():
    """A critic under a double-backward penalty may hold no batch norm when
    the batch is sharded: the trainers check their WGAN-GP and R0 critics
    at init (d_norm='none' passes)."""
    mesh = pmesh.Mesh(group=None, rank=0, world=2, device=torch.device('cpu'))
    cfg = cfg_mod.ColorTextureConfig(style_dim=16, g_hidden_dim=8,
                                     d_hidden_dim=8)
    ColorTextureTrainer(cfg, device='cpu', mesh=mesh).init_state()
    with pytest.raises(ValueError, match='gradient penalty'):
        ColorTextureTrainer(dataclasses.replace(cfg, d_norm='bn'),
                            device='cpu', mesh=mesh).init_state()
    bn = torch.nn.Sequential(RunningBatchNorm(3))
    L.assert_penalty_critic(bn, None)
    with pytest.raises(ValueError):
        L.assert_penalty_critic(bn, mesh)
    set_sync(bn, mesh)
    assert bn[0].mesh is mesh
