# The port's shape trainer (ctrlhair_tpu_torch/training/shape_trainer.py)
# against the JAX package's, at the tiny config of tests/test_training.py.
# Both sides start from the same state (JAX's, through the flax state-dict
# layout they share) and take the same batches; the JAX step runs unchanged
# on its own PRNG keys and the port is handed the draws JAX made from them
# (the split chain of _train_step and _forward).  Bars, as in
# tests/test_torch_trainers.py: after one step every loss, parameter, Adam
# moment and count agrees within 1e-5 (of the larger of 1 and the leaf's
# largest magnitude), after three within 1e-4; a NaN batch leaves the
# state bit-identical.
#
# One exemption, named and counted: a parameter entry whose gradient is
# rounding noise (below 1e-5 of its leaf's largest gradient, and not
# reproduced by the two sides to 1%) is moved by Adam by up to lr either
# way, since Adam divides a gradient by its own magnitude.  Such entries are
# held to "moved at most 2 lr a step on both sides" instead of the bar, and
# counted; the test asserts they stay under 0.1% of the trained entries.
# Measured (240,901 trained entries): 14, 28 and 67 after steps 1 to 3 with
# the defaults, 14, 31 and 53 with every option; only one of them, in
# face_encoder/out/fc/kernel with every option on, breaks the one-step bar
# (by 2.1e-5, 0.1 lr).
import dataclasses

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctrlhair_tpu.training import shape_trainer as jst
from ctrlhair_tpu.utils import checkpoint as jckpt
from ctrlhair_tpu_torch.convert import load_variables
from ctrlhair_tpu_torch.convert.load import pick_variables
from ctrlhair_tpu_torch.models.shape import ShapeGenerator
from ctrlhair_tpu_torch.training import shape_trainer as pst
from ctrlhair_tpu_torch.utils import checkpoint as ckpt
from test_torch_trainers import (
    ONE_STEP, THREE_STEPS, assert_metrics, assert_trees,
    assert_trees_noise_exempt, port_cfg, state_dict, to_torch)
from test_training import TINY_SHAPE

OPTIONS = dataclasses.replace(
    TINY_SHAPE, kl_free_bits=0.25, lambda_geo=30.0, lambda_info=1.0,
    lambda_moment_1=1.0, lambda_moment_2=1.0, disturb_real_batch_mask=True)
CONFIGS = {'defaults': TINY_SHAPE, 'options': OPTIONS}
NOISE_SHARE_MAX = 1e-3
BATCH = 4


@pytest.fixture(scope='module')
def jax_trainers():
    """One JAX trainer (one compile of its step) per config."""
    return {k: jst.ShapeTrainer(cfg) for k, cfg in CONFIGS.items()}


def jax_draws(rng, cfg, batch):
    """The draws of JAX's _train_step(rng) / _forward(k_fwd)."""
    k_fwd, k_dreal = jax.random.split(rng)
    k_vae, k_noise, k_branch, k_t, k_f, k_info = jax.random.split(k_fwd, 6)
    n = batch['target'].shape[0]
    t = lambda x: torch.tensor(np.asarray(x))
    prob = 0.5 if cfg.lambda_info > 0 else cfg.random_ae_prob
    out = {'eps_vae': t(jax.random.normal(k_vae, (n, cfg.hair_dim))),
           'real_noise': t(jax.random.normal(k_noise, (n, cfg.hair_dim))),
           'use_ae': t(jax.random.bernoulli(k_branch, prob))}
    if cfg.disturb_real_batch_mask:
        out['dist_target'] = t(jax.random.uniform(k_t,
                                                  batch['target'].shape))
        out['dist_face'] = t(jax.random.uniform(k_f, batch['face'].shape))
        out['dist_real'] = t(jax.random.uniform(k_dreal,
                                                batch['real'].shape))
    if cfg.lambda_info > 0:
        out['eps_info'] = t(jax.random.normal(k_info, (n, cfg.hair_dim)))
    return out


def shape_batch(cfg, seed, nan=False):
    batch = {k: np.asarray(v) for k, v in
             jst.synthetic_batch(jax.random.PRNGKey(seed), cfg,
                                 BATCH).items()}
    if nan:
        # the face mask feeds the face encoder (channel 0 is not hair)
        batch['face'] = batch['face'].copy()
        batch['face'][1, 3, 4, 0] = np.nan
    return batch


def run(jtr, steps, nan_at=None):
    cfg = jtr.cfg
    jstate = jtr.init_state(jax.random.PRNGKey(0))
    ptr = pst.ShapeTrainer(port_cfg(cfg), device='cpu')
    pstate = ptr.init_state()
    pstate.load_tree(state_dict(jstate))
    assert_trees(pstate.to_tree(), state_dict(jstate), 0)
    for step in range(steps):
        batch = shape_batch(cfg, 10 + step, nan=step == nan_at)
        rng = jax.random.PRNGKey(100 + step)
        before = state_dict(jstate)
        jstate, jm = jtr.train_step(
            jstate, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
        pstate, pm = ptr.train_step(pstate, to_torch(batch),
                                    jax_draws(rng, cfg, batch))
        yield step, jstate, jm, pstate, pm, before


def test_disturb_real_and_geo_stats():
    rng = np.random.default_rng(0)
    mask = rng.uniform(0, 1, (3, 32, 32, 19)).astype(np.float32)
    noise = jax.random.uniform(jax.random.PRNGKey(1), mask.shape)
    want = jst.disturb_real(jnp.asarray(mask), jax.random.PRNGKey(1))
    got = pst.disturb_real(torch.tensor(mask), torch.tensor(np.asarray(
        noise)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    for hair in (rng.uniform(0, 1, (4, 32, 32, 1)),
                 (rng.uniform(0, 1, (4, 64, 64, 1)) > 0.7) * 1.0,
                 np.zeros((2, 32, 32, 1))):
        hair = hair.astype(np.float32)
        np.testing.assert_allclose(
            pst.geo_stats(torch.tensor(hair)).numpy(),
            np.asarray(jst.geo_stats(jnp.asarray(hair))), rtol=0, atol=1e-6)


@pytest.mark.parametrize('which', ['defaults', 'options'])
def test_one_and_three_steps(jax_trainers, which):
    cfg = CONFIGS[which]
    exempt, prev = {}, None
    for step, jstate, jm, pstate, pm, before in run(jax_trainers[which], 3):
        tol = ONE_STEP if step == 0 else THREE_STEPS
        assert bool(jm['finite']) and bool(pm['finite'])
        assert ('g/lambda_geo' in pm) == (which == 'options')
        assert_metrics(pm, jm, tol)
        prev = prev or (before, before)
        now = (pstate.to_tree(), state_dict(jstate))
        counted = assert_trees_noise_exempt(
            *now, *prev, {'gen': cfg.lr_g, 'dis': cfg.lr_d,
                          'dis_noise': cfg.lr_dz}, cfg.beta1, tol, exempt)
        trained = sum(p.numel() for m in pstate.parts().values()
                      for p in m.module.parameters())
        assert counted <= NOISE_SHARE_MAX * trained
        prev = now


def test_nan_batch_leaves_state(jax_trainers):
    for step, jstate, jm, pstate, pm, before in run(
            jax_trainers['defaults'], 2, nan_at=1):
        if step == 0:
            mine = pstate.to_tree()
            continue
        assert not bool(jm['finite']) and not bool(pm['finite'])
        after = state_dict(jstate)
        assert int(after['step']) == int(before['step']) + 1
        after['step'] = before['step']
        assert_trees(after, before, 0)
        now = pstate.to_tree()
        assert int(now['step']) == 2
        now['step'] = mine['step']
        assert_trees(now, mine, 0)


def test_checkpoint_crosses_both_ways_with_geo_head(tmp_path):
    """A JAX train state with the geometry head restores into the port, the
    port's restores into JAX, bit for bit; the editor's loader drops the
    head and the generator loads strictly."""
    cfg = OPTIONS
    jtr = jst.ShapeTrainer(cfg)
    jstate = jtr.init_state(jax.random.PRNGKey(3))
    # a head that is not zero, so the layout is checked
    gp = jstate.gen.params
    head = gp['params']['geo_head']
    gp = {'params': dict(gp['params'], geo_head={
        'kernel': head['kernel'] + jnp.arange(head['kernel'].size).reshape(
            head['kernel'].shape) * 1e-3, 'bias': head['bias'] + 0.5})}
    jstate = jstate.replace(step=jstate.step + 4,
                            gen=jstate.gen.replace(params=gp))
    jckpt.save_checkpoint(str(tmp_path / 'jax'), jstate, 3)
    tree, step = ckpt.load_checkpoint(str(tmp_path / 'jax'))
    pstate = pst.ShapeTrainer(port_cfg(cfg), device='cpu').init_state(1)
    pstate.load_tree(tree)
    assert pstate.step == 4
    assert_trees(pstate.to_tree(), state_dict(jstate), 0)
    np.testing.assert_array_equal(
        pstate.gen.module.geo_head.weight.detach().numpy(),
        np.asarray(gp['params']['geo_head']['kernel']).T)
    pstate.step = 9
    ckpt.save_checkpoint(str(tmp_path / 'port'), pstate.to_tree(), 8)
    restored, step = jckpt.load_checkpoint(str(tmp_path / 'port'), jstate)
    assert step == 8 and int(restored.step) == 9
    assert_trees(state_dict(restored), pstate.to_tree(), 0)
    variables = pick_variables('shape', tree)['shape']
    assert 'geo_head' not in variables['params']
    gen = ShapeGenerator(port_cfg(cfg))
    load_variables(gen, 'shape', variables)


def test_synthetic_batch_contract():
    cfg = port_cfg(TINY_SHAPE)
    got = pst.synthetic_batch(torch.Generator().manual_seed(0), cfg, 3)
    ref = jst.synthetic_batch(jax.random.PRNGKey(0), TINY_SHAPE, 3)
    assert set(got) == set(ref)
    for k in ref:
        assert tuple(got[k].shape) == ref[k].shape
        assert torch.equal(got[k].sum(-1), torch.ones(got[k].shape[:-1]))


def test_run_shape_on_cpu_and_its_refusals(tmp_path, monkeypatch):
    """run_shape.main on synthetic batches (the published ShapeConfig
    swapped for the tiny one): three steps on the CPU write a checkpoint
    the JAX package restores into its trainer's state; without a card and
    without --device cpu it exits 2; --dp 2 without the
    launcher exits 2."""
    from ctrlhair_tpu_torch import config as cfg_mod
    from ctrlhair_tpu_torch.training import run_shape
    tiny = port_cfg(TINY_SHAPE)
    monkeypatch.setattr(cfg_mod, 'ShapeConfig', lambda: tiny)
    d = str(tmp_path / 'shape')
    state = run_shape.main(['--synthetic', '--steps', '3', '--device', 'cpu',
                            '--batch-size', '2', '--out-dir', d])
    assert state.step == 3
    target = jst.ShapeTrainer(TINY_SHAPE).init_state(jax.random.PRNGKey(0))
    restored, step = jckpt.load_checkpoint(
        str(tmp_path / 'shape' / 'checkpoints'), target)
    assert step == 2 and int(restored.step) == 3
    assert_trees(state_dict(restored), state.to_tree(), 0)
    # an empty data root falls back to synthetic batches
    state = run_shape.main(['--steps', '1', '--device', 'cpu',
                            '--batch-size', '2', '--data-root',
                            str(tmp_path), '--out-dir',
                            str(tmp_path / 'fallback')])
    assert state.step == 1
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(SystemExit) as e:
        run_shape.main(['--synthetic', '--steps', '1', '--out-dir',
                        str(tmp_path / 'none')])
    assert e.value.code == 2
    monkeypatch.delenv('WORLD_SIZE', raising=False)
    with pytest.raises(SystemExit) as e:     # no launcher: no ranks
        run_shape.main(['--dp', '2', '--synthetic'])
    assert e.value.code == 2
