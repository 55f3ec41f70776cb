# The port's data-parallel trainers against the JAX package's sharded
# step: the counterpart of tests/test_multichip_training.py for the
# colour/texture, shape and face-parser trainers (SEAN's is
# tests/test_torch_parallel_sean.py), plus the NaN gate and the resume
# across ranks, the dry run, and --dp in the entry points.
#
# Each family starts from one state, the port's seeded init (JAX's state
# is rebuilt from it through the flax state-dict layout both share), at the
# tiny configs of tests/test_multichip_training.py (colour/texture and the
# face parser at the dry run's, the parser's with one block a stage, which
# halves this file's time; colour/texture with lambda_rec_img through a
# tiny frozen SEAN and the moment terms on; shape with kl_free_bits, the
# moment terms and every option), a global batch of 8.  JAX's step runs sharded over make_mesh(2, tp=1); the
# port runs on W = 2 gloo ranks on the CPU (spawned once for the module,
# beside JAX's compiles) on its rows of the batch with JAX's global draws,
# and in one process on the whole batch.
#
# Bars, as tests/test_torch_trainers.py holds the single-process steps:
# after one step every leaf of the port's state within 1e-5 of JAX's
# (scaled by max(1, the leaf's largest magnitude)), metrics too, and of the
# port's single-process step; with the models computing in float64 on
# both, within 1e-6 of the single-process step (in float32 the two sums of
# a batch, whole and in halves, stand up to 3e-6 apart in the gradients of
# conv biases summed over every pixel); the Adam-trained entries whose
# gradient is rounding noise held instead to "moved at most 2 lr" and
# counted (assert_trees_noise_exempt: Adam divides a gradient by its own
# magnitude, so the sign of noise decides a step of lr), at most 0.1% of the
# entries.  Every rank's state is bit-identical to every other's.  A NaN in
# the last rank's rows gates every rank's update (the state bit-identical
# to before the step); a run checkpointed by rank 0 after its first step
# and resumed on both ranks equals the unbroken two-step run bit for bit.
import concurrent.futures
import dataclasses
import os
import subprocess
import sys

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctrlhair_tpu import config as jcfg_mod
from ctrlhair_tpu.models.sean import SEAN as JaxSEAN
from ctrlhair_tpu.parallel import mesh as jmesh
from ctrlhair_tpu.training import shape_trainer as jst
from ctrlhair_tpu.training.bisenet_trainer import (
    BiSeNetTrainer as JaxBiSeNetTrainer)
from ctrlhair_tpu.training.color_texture_trainer import (
    ColorTextureTrainer as JaxCTTrainer)
from ctrlhair_tpu_torch.convert import to_flax
from ctrlhair_tpu_torch.models.layers import init_parameters_
from ctrlhair_tpu_torch.models.sean import SEAN
from ctrlhair_tpu_torch.parallel.dryrun import dryrun_multichip, run_on_ranks
from test_torch_shape_trainer import jax_draws as shape_jax_draws
from test_torch_trainers import (
    TINY_CT, TINY_SEAN, assert_metrics, assert_trees,
    assert_trees_noise_exempt, ct_batch, jax_draws as ct_jax_draws,
    port_cfg, state_dict)
import torch_parallel_ranks as ranks

WORLD, N = 2, 8
ONE_STEP, SINGLE = 1e-5, 1e-6
NOISE_SHARE_MAX = 1e-3
CT = dataclasses.replace(TINY_CT, lambda_rec_img={0: 10.0})
SHAPE = dataclasses.replace(
    jcfg_mod.ShapeConfig(img_size=32, layer_num=4, max_channel=64,
                         hidden_in_channel=8, face_dim=32),
    kl_free_bits=0.25, lambda_geo=30.0, lambda_info=1.0,
    lambda_moment_1=1.0, lambda_moment_2=1.0, disturb_real_batch_mask=True)
BISENET = jcfg_mod.BiSeNetConfig(input_size=32, blocks_per_stage=1)
FAMILIES = ('color_texture', 'shape', 'bisenet')
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def numpy_draws(draws):
    return {k: np.asarray(v.numpy()) for k, v in draws.items()}


def with_nan(batch, key, index):
    out = {k: v.copy() for k, v in batch.items()}
    out[key][index] = np.nan
    return out


def template(fn):
    """The pytree fn returns, traced only (no compile, no values)."""
    return jax.eval_shape(fn)


def jax_sharded_step(jtr, jstate, batch, extra, rng, world=WORLD, tp=1):
    """JAX's step with the batch sharded over make_mesh(world, tp), the
    state and `extra` replicated, and with tp > 1 the generator's and the
    discriminator's parameters placed by shard_params, as JAX's dry run
    places them: (state dict, metrics)."""
    mesh = jmesh.make_mesh(world, tp=tp)
    with mesh:
        jstate = jax.device_put(jstate, jmesh.replicated(mesh))
        if tp > 1:
            jstate = jstate.replace(**{
                k: getattr(jstate, k).replace(params=jmesh.shard_params(
                    getattr(jstate, k).params, mesh))
                for k in ('gen', 'dis')})
        extra = [jax.device_put(e, jmesh.replicated(mesh)) for e in extra]
        sharded = jmesh.shard_batch(
            {k: jnp.asarray(v) for k, v in batch.items()}, mesh)
        new, metrics = jtr.train_step(jstate, sharded, *extra, rng)
        jax.block_until_ready(metrics)
    return state_dict(new), jax.device_get(metrics)


# ---------------------------------------------------------------- specs
def ct_spec(world=WORLD, tp=1):
    cfg = port_cfg(CT)
    sean = SEAN(port_cfg(TINY_SEAN))
    init_parameters_(sean, torch.Generator().manual_seed(1))
    from ctrlhair_tpu_torch.training.color_texture_trainer import (
        ColorTextureTrainer)
    state, preds = ColorTextureTrainer(cfg, device='cpu').init_state(2)
    batches = [ct_batch(CT, 20 + i, N, True) for i in range(3)]
    rng = jax.random.PRNGKey(200)
    spec = {'cfg': cfg, 'sean_cfg': port_cfg(TINY_SEAN),
            'sean_state': {k: v.numpy() for k, v in
                           sean.state_dict().items()},
            'pred_states': {k: {n: t.numpy() for n, t in
                                p.state_dict().items()}
                            for k, p in preds.items()},
            'init_tree': state.to_tree(), 'batches': batches,
            'nan_batch': with_nan(batches[0], 'code', (N - 1, 2)),
            'draws': numpy_draws(ct_jax_draws(
                rng, N, CT.gan_input_from_encoder_prob))}

    def jax_step():
        jtr = JaxCTTrainer(CT, sean=JaxSEAN(TINY_SEAN),
                           sean_params=to_flax(sean, 'sean'))
        jstate = flax.serialization.from_state_dict(
            template(lambda: jtr.init_state(jax.random.PRNGKey(0))[0]),
            spec['init_tree'])
        jpred = {k: to_flax(p, k) for k, p in preds.items()}
        return jax_sharded_step(jtr, jstate, batches[0], [jpred], rng,
                                world, tp)
    lrs = {'gen': CT.lr_g, 'dis': CT.lr_d, 'dis_noise': CT.lr_g}
    return spec, jax_step, (lrs, CT.beta1)


def shape_spec(world=WORLD, tp=1):
    from ctrlhair_tpu_torch.training.shape_trainer import ShapeTrainer
    state = ShapeTrainer(port_cfg(SHAPE), device='cpu').init_state(3)
    batches = [{k: np.asarray(v) for k, v in jst.synthetic_batch(
        jax.random.PRNGKey(10 + i), SHAPE, N).items()} for i in range(3)]
    rng = jax.random.PRNGKey(100)
    spec = {'cfg': port_cfg(SHAPE), 'init_tree': state.to_tree(),
            'batches': batches,
            'nan_batch': with_nan(batches[0], 'face', (N - 1, 3, 4, 0)),
            'draws': numpy_draws(shape_jax_draws(rng, SHAPE, batches[0]))}

    def jax_step():
        jtr = jst.ShapeTrainer(SHAPE)
        jstate = flax.serialization.from_state_dict(
            template(lambda: jtr.init_state(jax.random.PRNGKey(0))),
            spec['init_tree'])
        return jax_sharded_step(jtr, jstate, batches[0], [], rng, world,
                                tp)
    lrs = {'gen': SHAPE.lr_g, 'dis': SHAPE.lr_d, 'dis_noise': SHAPE.lr_dz}
    return spec, jax_step, (lrs, SHAPE.beta1)


def bisenet_spec():
    from ctrlhair_tpu_torch.training.bisenet_trainer import BiSeNetTrainer
    state = BiSeNetTrainer(port_cfg(BISENET), device='cpu').init_state(4)
    rng = np.random.default_rng(0)
    batches = [{'image': rng.standard_normal((N, 32, 32, 3)).astype(
                    np.float32),
                'label': rng.integers(0, 19, (N, 32, 32)).astype(np.int32)}
               for _ in range(3)]
    spec = {'cfg': port_cfg(BISENET), 'init_tree': state.to_tree(),
            'batches': batches,
            'nan_batch': with_nan(batches[0], 'image', (N - 1, 5, 6, 2)),
            'draws': None}

    def jax_step():
        jtr = JaxBiSeNetTrainer(BISENET)
        jstate = flax.serialization.from_state_dict(
            template(lambda: jtr.init_state(jax.random.PRNGKey(0))),
            spec['init_tree'])
        return jax_sharded_step(jtr, jstate, batches[0], [],
                                jax.random.PRNGKey(2))
    return spec, jax_step, None


SPECS = {'color_texture': ct_spec, 'shape': shape_spec,
         'bisenet': bisenet_spec}


def run_families(specs_fns, tmp, world=WORLD, tp=1,
                 rank_fn=ranks.families_on_rank, payload=None):
    """{'specs', 'ranks' (per rank), 'single', 'jax', 'adam'} of the given
    cases ({name: () -> (spec, JAX's step or None, Adam's (lrs, b1) or
    None)}): the ranks of make_mesh(world, tp) in a thread, JAX's sharded
    steps and the port's single-process steps in this one.  The ranks run
    rank_fn(mesh, specs), or rank_fn(mesh, payload(specs)) given a
    payload function."""
    built = {f: fn() for f, fn in specs_fns.items()}
    specs = {f: dict(b[0], tmp=str(tmp)) for f, b in built.items()}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        on_ranks = pool.submit(run_on_ranks, rank_fn, world,
                               payload(specs) if payload else specs,
                               deadline_s=300.0, tp=tp)
        jax_out = {f: b[1]() for f, b in built.items() if b[1]}
        single = {f: ranks.trainer_checks(None, spec.get('family', f),
                                          spec, full=False)
                  for f, spec in specs.items()}
        per_rank = on_ranks.result()
    return {'specs': specs, 'ranks': per_rank, 'single': single,
            'jax': jax_out, 'adam': {f: b[2] for f, b in built.items()}}


@pytest.fixture(scope='module')
def run(tmp_path_factory):
    return run_families(SPECS, tmp_path_factory.mktemp('ckpt'))


def check_step(run, family, noise=None, share=NOISE_SHARE_MAX,
               jax_bar=ONE_STEP):
    """The step's bars (the header's), shared with the SEAN file, whose
    `noise(got, ref, exempt)` adds the entries its own test exempts, and
    whose exempt share is its own test's, and with the tensor-parallel
    file, whose state bar against JAX's step is `jax_bar`."""
    init = run['specs'][family]['init_tree']
    per_rank = [r[family] for r in run['ranks']]
    got, metrics = per_rank[0]['step']
    for r in per_rank[1:]:
        assert_trees(r['step'][0], got, 0)
    assert per_rank[0]['collectives'] > 0
    ref, jm = run['jax'][family]
    single, single_m = run['single'][family]['step']
    assert bool(jm['finite']) and bool(metrics['finite'])
    assert_metrics(metrics, jm, ONE_STEP)
    assert_metrics(metrics, single_m, ONE_STEP)
    pairs = [(got, ref, jax_bar), (got, single, ONE_STEP)]
    if 'step64' in per_rank[0]:
        pairs.append((per_rank[0]['step64'][0],
                      run['single'][family]['step64'][0], SINGLE))
    adam = run['adam'][family]
    for a, b, tol in pairs:
        if adam is None:        # SGD: linear in the gradient, no exemption
            assert_trees(a, b, tol)
            continue
        lrs, b1 = adam
        total = sum(np.asarray(v).size for part in lrs for v in
                    jax.tree_util.tree_leaves(init[part]['params']))
        exempt = {}
        if noise is not None:
            noise(a, b, exempt)
        count = assert_trees_noise_exempt(a, b, init, init, lrs, b1, tol,
                                          exempt)
        assert count <= share * total, count


def check_nan_and_resume(run, family, moved=()):
    """A NaN in the last rank's rows: not finite on any rank, every rank's
    state as before the step (`moved` leaves aside), all ranks alike; the
    resumed run equals the unbroken one bit for bit on every rank."""
    per_rank = [r[family] for r in run['ranks']]
    for r in per_rank:
        before, after, finite = r['nan']
        assert not finite
        assert int(after['step']) == int(before['step']) + 1
        kept = lambda t: {k: v for k, v in t.items()
                          if k != 'step' and k not in moved}
        assert_trees(kept(after), kept(before), 0)
        assert_trees(after, per_rank[0]['nan'][1], 0)
        assert_trees(r['resumed'], r['unbroken'], 0)
        assert_trees(r['unbroken'], per_rank[0]['unbroken'], 0)


@pytest.mark.parametrize('family', FAMILIES)
def test_dp_step_equals_jax_sharded_and_single(run, family):
    """On 2 ranks the port's step equals JAX's step sharded over
    make_mesh(2, tp=1) and the port's own single-process step on the
    global batch; every rank holds the same state."""
    check_step(run, family)


@pytest.mark.parametrize('family', FAMILIES)
def test_nan_in_one_rank_and_resume_on_ranks(run, family):
    check_nan_and_resume(run, family)


def test_dryrun_multichip_two_ranks():
    """dryrun_multichip(2): the four families' steps over 2 gloo ranks
    (tp = 2, as JAX's dry run takes it for an even count), each finite."""
    dryrun_multichip(2, deadline_s=240.0)


ENTRY_POINTS = ('run_color_texture', 'run_shape', 'run_bisenet', 'run_sean')


@pytest.mark.parametrize('name', ENTRY_POINTS)
def test_entry_point_dp_needs_the_launcher(name, monkeypatch, capsys):
    """--dp N means N ranks under python -m torch.distributed.run: without
    the launcher --dp 2 exits 2, and under it a --dp other than its
    WORLD_SIZE exits 2, before any process group is set up."""
    import importlib
    main = importlib.import_module(
        f'ctrlhair_tpu_torch.training.{name}').main
    monkeypatch.delenv('WORLD_SIZE', raising=False)
    with pytest.raises(SystemExit) as e:
        main(['--dp', '2', '--synthetic', '--device', 'cpu'])
    assert e.value.code == 2
    assert 'torch.distributed.run' in capsys.readouterr().err
    monkeypatch.setenv('WORLD_SIZE', '2')
    with pytest.raises(SystemExit) as e:
        main(['--dp', '3', '--synthetic', '--device', 'cpu'])
    assert e.value.code == 2
    assert 'WORLD_SIZE' in capsys.readouterr().err
    assert not torch.distributed.is_initialized()


def test_run_bisenet_under_the_launcher(tmp_path, monkeypatch, capsys):
    """python -m torch.distributed.run --nproc_per_node 2 ... run_bisenet
    --dp 2 on the CPU: one step leaves rank 0's checkpoint, which
    run_bisenet resumes for a second step (in this process, on the whole
    batch), its checkpoint reading back into a state with finite
    weights."""
    from ctrlhair_tpu_torch.training import run_bisenet
    from ctrlhair_tpu_torch.utils.checkpoint import load_checkpoint
    out = str(tmp_path / 'out')
    launcher_env = ('WORLD_SIZE', 'RANK', 'LOCAL_RANK', 'MASTER_ADDR',
                    'MASTER_PORT')
    env = {k: v for k, v in os.environ.items() if k not in launcher_env}
    env['OMP_NUM_THREADS'] = '1'
    args = ['--synthetic', '--device', 'cpu', '--input-size', '32',
            '--batch-size', '4', '--out-dir', out]
    proc = subprocess.run(
        [sys.executable, '-m', 'torch.distributed.run', '--standalone',
         '--nproc_per_node', '2', '-m',
         'ctrlhair_tpu_torch.training.run_bisenet', '--dp', '2', '--steps',
         '1'] + args,
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert load_checkpoint(os.path.join(out, 'checkpoints'))[1] == 0
    for k in launcher_env:
        monkeypatch.delenv(k, raising=False)
    state = run_bisenet.main(['--steps', '2'] + args)
    assert 'resumed from step 0' in capsys.readouterr().out
    tree, step = load_checkpoint(os.path.join(out, 'checkpoints'))
    assert step == 1 and state.step == 2
    assert_trees(tree, state.to_tree(), 0)
    assert all(bool(torch.isfinite(p).all())
               for p in state.model.module.parameters())
