# The port's tensor parallelism (ctrlhair_tpu_torch/parallel/mesh.py's tp
# axis, the column-parallel layers of models/layers.py, the sharded train
# state) against the JAX package's: the counterpart of tests/test_multichip_
# training.py::test_shape_trainer_dp_tp_step_equals_single_device for the
# two trainers JAX's dry run shards, colour/texture and shape.
#
# The port runs on 4 gloo ranks on the CPU as make_mesh(4, tp=2) (dp 2 x
# tp 2; spawned once for the module, beside JAX's compiles), JAX's step
# over jax make_mesh(4, tp=2) with the generator's and discriminator's
# parameters placed by shard_params, the port's reference in one process
# on the whole batch.  The cases are those of tests/test_torch_parallel_
# trainers.py: the shape trainer at that test's config (img_size 32,
# layer_num 4, max_channel 64) with every option of the shape trainer on,
# colour/texture at the dry run's config with lambda_rec_img through a tiny
# frozen SEAN; one state, JAX's global draws, a global batch of 8.
#
# Bars, those of tests/test_torch_parallel_trainers.py: after one step
# every leaf within 1e-5 of the single process's (scaled by max(1, the
# leaf's largest magnitude)), metrics too, with the models computing in
# float64 within 1e-6 of the single process, the entries whose gradient is
# rounding noise held to "moved at most 2 lr" and counted; every rank's
# gathered state bit-identical.  Against JAX's step over make_mesh(4,
# tp=2) the state is held to JAX's own bar for that step, 3e-5
# (tests/test_multichip_training.py): JAX's tp placement moves JAX's own
# step, and the port's steps, on the ranks and in one process alike,
# stand 1.19e-5 and 1.15e-5 of its scale from it at Adam's mu of the
# shape generator's hair_encoder/down_1 kernel, 2.4e-6 from each other
# (the CPU, torch 2.13; the test records the three gaps of the moments
# as junit properties).  A NaN in one rank's rows, and a NaN in one
# entry of one tp rank's gradient slice, each leave every rank's state as
# it was; a resume equals the unbroken run bit for bit; a checkpoint
# crosses between tp 2 and one process both ways.  The column-parallel
# layers' double backward, in float64, equals the unsharded layers' to
# 1e-12 of each gradient's scale.
import jax
import numpy as np
import pytest
import torch

from ctrlhair_tpu.parallel import mesh as jmesh
from ctrlhair_tpu.training import shape_trainer as jst
from ctrlhair_tpu.training.color_texture_trainer import (
    ColorTextureTrainer as JaxCTTrainer)
from ctrlhair_tpu_torch.convert import flax_param_layout, to_flax
from ctrlhair_tpu_torch.models.layers import set_tp, tp_shards
from ctrlhair_tpu_torch.parallel import mesh as pmesh
from ctrlhair_tpu_torch.parallel.dryrun import dryrun_multichip
from ctrlhair_tpu_torch.training.loop import run_training
from ctrlhair_tpu_torch.utils.checkpoint import load_checkpoint
from test_torch_parallel_trainers import (
    CT, NOISE_SHARE_MAX, ONE_STEP, SHAPE, check_nan_and_resume, check_step,
    ct_spec, run_families, shape_spec)
from test_torch_trainers import assert_trees, assert_trees_noise_exempt
import torch_parallel_ranks as ranks

WORLD, TP = 4, 2
FAMILIES = ('color_texture', 'shape')
JAX_TP_BAR = 3e-5
DOUBLE_BACKWARD_BAR = 1e-12


def moments_gap(got, ref):
    """The largest |got - ref| over Adam's moments of two state trees, each
    leaf scaled by max(1, its largest magnitude in ref) (the parameters
    hold the noise entries, whose moves are held apart)."""
    flat = jax.tree_util.tree_flatten_with_path(ref)[0]
    other = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    return max(float(np.abs(np.asarray(other[p], np.float64) - v).max())
               / max(1.0, float(np.abs(v).max()))
               for p, v in flat if np.asarray(v).size
               and 'opt_state' in jax.tree_util.keystr(p))


def single_checkpoint(family, spec, ckpt_dir):
    """run_training's one step in this process (the trainer's own draws),
    checkpointed into ckpt_dir."""
    trainer, state, extra = ranks.make_trainer(family, spec, None)
    run_training(state, trainer.train_step,
                 lambda step: ranks.tensors(spec['batches'][step]), 1,
                 step_args=lambda: extra, ckpt_dir=ckpt_dir, verbose=False)


@pytest.fixture(scope='module')
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('tp')
    dirs = {}

    def payload(specs):
        dirs.update({
            'single_dirs': {f: str(tmp / 'single' / f) for f in specs},
            'tp_dirs': {f: str(tmp / 'tp2' / f) for f in specs}})
        for f, spec in specs.items():
            single_checkpoint(f, spec, dirs['single_dirs'][f])
        return {'specs': specs, **dirs}

    out = run_families(
        {'color_texture': lambda: ct_spec(WORLD, TP),
         'shape': lambda: shape_spec(WORLD, TP)},
        tmp, world=WORLD, tp=TP, rank_fn=ranks.tp_on_rank, payload=payload)
    out['dirs'] = dirs
    return out


@pytest.mark.parametrize('family', FAMILIES)
def test_tp_step_equals_jax_and_single(run, family, record_property):
    """On make_mesh(4, tp=2) the port's step equals JAX's step over
    make_mesh(4, tp=2) with gen and dis sharded (JAX's bar for it), and
    the port's own step in one process; every rank holds the same gathered
    state.  The gaps of the three steps' Adam moments are recorded."""
    tp = run['ranks'][0][family]['step'][0]
    jax_tree = run['jax'][family][0]
    single = run['single'][family]['step'][0]
    for name, a, b in (('tp_vs_jax', tp, jax_tree),
                       ('single_vs_jax', single, jax_tree),
                       ('tp_vs_single', tp, single)):
        record_property(name, moments_gap(a, b))
    check_step(run, family, jax_bar=JAX_TP_BAR)


@pytest.mark.parametrize('family', FAMILIES)
def test_tp_nan_in_one_rank_and_resume(run, family):
    check_nan_and_resume(run, family)


@pytest.mark.parametrize('family', FAMILIES)
def test_nan_in_one_shard_gates_every_rank(run, family):
    """A NaN in one entry of tp rank 1's slice of a sharded gradient (the
    other tp rank's gradients finite): the finite flag, reduced over the tp
    ranks, is false on all four ranks, and no rank's state moved."""
    per_rank = [r[family]['nan_shard'] for r in run['ranks']]
    for before, after, finite in per_rank:
        assert not finite
        assert int(after['step']) == int(before['step']) + 1
        strip = lambda t: {k: v for k, v in t.items() if k != 'step'}
        assert_trees(strip(after), strip(before), 0)
        assert_trees(after, per_rank[0][1], 0)


@pytest.mark.parametrize('family', FAMILIES)
def test_checkpoints_cross_tp_sizes(run, family):
    """A checkpoint written in one process loads at tp 2 (each rank's
    gathered tree equals the file bit for bit); one written by rank 0 at
    tp 2 after a step of run_training is within the step's bar of one
    process's (noise entries exempt, as in check_step) and loads in one
    process bit for bit."""
    spec = run['specs'][family]
    single, _ = load_checkpoint(run['dirs']['single_dirs'][family])
    for r in run['ranks']:
        assert_trees(r[family]['loaded'], single, 0)
    written, step = load_checkpoint(run['dirs']['tp_dirs'][family])
    assert step == 0
    lrs, b1 = run['adam'][family]
    init = spec['init_tree']
    count = assert_trees_noise_exempt(written, single, init, init, lrs, b1,
                                      ONE_STEP, {})
    total = sum(np.asarray(v).size for part in lrs for v in
                jax.tree_util.tree_leaves(init[part]['params']))
    assert count <= NOISE_SHARE_MAX * total
    _, state, _ = ranks.make_trainer(family, spec, None)
    state.load_tree(written)
    assert_trees(state.to_tree(), written, 0)


def test_mesh_layout(run):
    """Rank r at dp index r // 2 and tp index r % 2, dp 2 x tp 2, as JAX's
    reshape(n // tp, tp) places devices."""
    assert [r['mesh'] for r in run['ranks']] == [
        (r // TP, r % TP, WORLD // TP, TP) for r in range(WORLD)]


def test_column_parallel_double_backward(run):
    """A float64 critic of sharded Conv, ConvTranspose and Dense layers
    under a penalty on its input gradient: on each tp pair of ranks its
    loss, its input gradient and every parameter gradient of the double
    backward equal the unsharded critic's."""
    for r in run['ranks']:
        gaps = r['critic']
        assert max(gaps.values()) <= DOUBLE_BACKWARD_BAR, gaps


def jax_params(family):
    """JAX's gen and dis parameter trees of the family's trainer (shapes
    only), and the port's modules of the same state."""
    if family == 'color_texture':
        jtr = JaxCTTrainer(CT)
        state = jax.eval_shape(lambda: jtr.init_state(
            jax.random.PRNGKey(0))[0])
    else:
        jtr = jst.ShapeTrainer(SHAPE)
        state = jax.eval_shape(lambda: jtr.init_state(
            jax.random.PRNGKey(0)))
    spec = (ct_spec if family == 'color_texture' else shape_spec)()[0]
    _, port_state, _ = ranks.make_trainer(family, dict(spec, tmp=''), None)
    return {k: (getattr(state, k).params, getattr(port_state, k).module)
            for k in ('gen', 'dis')}


@pytest.mark.parametrize('family', FAMILIES)
def test_param_shardings_match_jax(family):
    """param_shardings marks the leaves JAX's param_shardings shards over
    'tp' on make_mesh(4, tp=2), path for path, and the dim it names holds
    the flax kernel's last axis: zeroing the upper half of the torch
    tensor along it zeroes the upper half of that axis in to_flax's tree.
    shard_params keeps the slice of this rank's tp index."""
    mesh = jmesh.make_mesh(WORLD, tp=TP)
    fake = pmesh.Mesh(group=None, rank=0, world=WORLD // TP,
                      device=torch.device('cpu'), tp=TP, tp_rank=1)
    n_sharded = 0
    for part, (jparams, module) in jax_params(family).items():
        jspecs = {tuple(p.key for p in path): tuple(s.spec)
                  for path, s in jax.tree_util.tree_flatten_with_path(
                      jmesh.param_shardings(jparams, mesh))[0]}
        got = pmesh.param_shardings(module, fake)
        assert set(got) == set(jspecs), part
        for path, dim in got.items():
            jaxis = 'tp' in jspecs[path]
            assert (dim is not None) == jaxis, (part, path)
            if jaxis:
                assert jspecs[path][-1] == 'tp', (part, path)
        layout = flax_param_layout(module)
        params = dict(module.named_parameters())
        for name, (path, shape, last) in layout.items():
            if got[path] is None:
                continue
            n_sharded += 1
            assert got[path] == last
            w = params[name].detach()
            half = w.shape[last] // TP
            cut = w.clone()
            cut.narrow(last, half, w.shape[last] - half).zero_()
            tree = to_flax(module, 'ct_gen' if family == 'color_texture'
                           else 'shape', {name: cut})
            whole = to_flax(module, 'ct_gen' if family == 'color_texture'
                            else 'shape', {name: w})
            for p in path[:-1]:
                tree, whole = tree[p], whole[p]
            k_cut, k_whole = tree[path[-1]], whole[path[-1]]
            assert k_cut.shape == shape
            np.testing.assert_array_equal(k_cut[..., :half],
                                          k_whole[..., :half])
            assert not k_cut[..., half:].any()
        slices = {n: params[n].detach().narrow(d, params[n].shape[d] // TP,
                                               params[n].shape[d] // TP)
                  for n, d in pmesh.sharded_params(module, fake).items()}
        set_tp(module, fake)
        assert sorted(tp_shards(module)) == sorted(slices)
        after = dict(module.named_parameters())
        for n, s in slices.items():
            assert torch.equal(after[n], s)
    assert n_sharded > 0


def test_dryrun_multichip_four_ranks_tp2(capfd):
    """dryrun_multichip(4): JAX's tp = 2 for an even count, dp 2; the four
    families' steps finite."""
    dryrun_multichip(4, deadline_s=240.0)
    assert 'dp=2, tp=2' in capfd.readouterr().out
