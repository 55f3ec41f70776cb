# The port's trainers (ctrlhair_tpu_torch/training/predictor_trainer.py,
# color_texture_trainer.py) against the JAX package's, at the tiny configs
# of tests/test_training.py.  Each side starts from the same state (JAX's,
# through the flax state-dict layout both share), takes the same batches,
# and the JAX step runs unchanged on its own PRNG keys; the port is handed
# the draws JAX made from them (the split chain of _train_step / _forward,
# and the dropout masks flax drew, read off the Dropout layers' outputs).
# After one step every loss, parameter, Adam moment, count and BatchNorm
# statistic agrees within 1e-5 (of the larger of 1 and the leaf's largest
# magnitude); after three, within 1e-4; a step on a
# batch with a NaN leaves the state bit-identical on both sides.
#
# One exception, which no implementation can meet and which the test holds
# in its own way: the bias of a Dense layer that feeds a batch-statistics
# BatchNorm (the predictors' hidden layers) has a gradient of exactly zero
# (the norm subtracts any constant), so each side computes rounding noise
# (1e-7 of the largest gradient here), and Adam, which divides a gradient by
# its own magnitude, turns that noise into a step of +-lr whose sign neither
# side shares.  For those biases the test checks that both sides' gradient
# is noise (|mu| <= 1e-5 of the largest |mu|), that each step moved them by
# at most 2 lr (Adam's step is near lr), and that the running mean downstream differs from JAX's by
# exactly what the two bias histories predict (0.1 of the bias difference a
# step, decayed by 0.9), within the same bar; nothing else moves with them,
# because the norm cancels them.  The
# colour/texture step is held with lambda_rec_img off and on (through a
# tiny SEAN).
import dataclasses

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctrlhair_tpu import config as jcfg_mod
from ctrlhair_tpu.models.color_texture import Predictor as JaxPredictor
from ctrlhair_tpu.models.sean import SEAN as JaxSEAN
from ctrlhair_tpu.training.color_texture_trainer import (
    ColorTextureTrainer as JaxCTTrainer, synthetic_batch as jax_ct_batch)
from ctrlhair_tpu.training.predictor_trainer import (
    PredictorTrainer as JaxPredictorTrainer)
from ctrlhair_tpu_torch import config as cfg_mod
from ctrlhair_tpu_torch.convert import load_variables
from ctrlhair_tpu_torch.models.sean import SEAN
from ctrlhair_tpu_torch.training.color_texture_trainer import (
    ColorTextureTrainer, synthetic_batch)
from ctrlhair_tpu_torch.training.predictor_trainer import PredictorTrainer

TINY_CT = jcfg_mod.ColorTextureConfig(style_dim=64, g_hidden_dim=32,
                                      d_hidden_dim=32)
TINY_SEAN = jcfg_mod.SEANConfig(crop_size=32, ngf=2, zencoder_ngf=2,
                                style_dim=64)
ONE_STEP, THREE_STEPS = 1e-5, 1e-4


def port_cfg(jcfg):
    """The port's dataclass with the JAX one's field values."""
    cls = getattr(cfg_mod, type(jcfg).__name__)
    return cls(**{f.name: getattr(jcfg, f.name)
                  for f in dataclasses.fields(jcfg)})


def state_dict(state):
    return flax.serialization.to_state_dict(jax.device_get(state))


def to_torch(batch):
    return {k: torch.tensor(np.asarray(v)) for k, v in batch.items()}


def assert_trees(got, ref, tol):
    """Same keys everywhere; every leaf within tol of JAX's, scaled by the
    leaf's largest magnitude (|a-b| <= tol * max(1, max|b|)); tol 0 is bit
    equality."""
    g, r = (jax.tree_util.tree_flatten_with_path(t)[0] for t in (got, ref))
    assert [p for p, _ in g] == [p for p, _ in r]
    for (path, a), (_, b) in zip(g, r):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, path
        if tol == 0:
            np.testing.assert_array_equal(a, b, err_msg=str(path))
        else:
            scale = max(1.0, float(np.abs(b).max())) if b.size else 1.0
            np.testing.assert_allclose(a, b, rtol=0, atol=tol * scale,
                                       err_msg=str(path))


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def assert_trees_noise_exempt(got, ref, prev_got, prev_ref, lrs, b1, tol,
                              exempt):
    """assert_trees(got, ref, tol) for Adam-trained state trees (parts
    {part: lr}, each a ModelOpt tree), with one exemption: an entry whose
    gradient of this step is rounding noise (below 1e-5 of its leaf's
    largest gradient on JAX's side, and not reproduced by the two sides to
    1%; the gradient read off Adam's first moment, (mu - b1 mu_prev) /
    (1 - b1)) is held instead to a move of at most 2 lr per step on both
    sides, since Adam divides a gradient by its own magnitude.  `exempt`
    accumulates {(part, leaf): mask} over the steps; returns the number of
    exempted entries."""
    for part in lrs:
        grads = []
        for now, prev in ((got, prev_got), (ref, prev_ref)):
            mu, mu0 = (_leaves(t[part]['opt_state']['0']['mu'])
                       for t in (now, prev))
            grads.append({k: (mu[k] - b1 * mu0[k]) / (1 - b1) for k in mu})
        for k, g_ref in grads[1].items():
            mask = (np.abs(g_ref) <= 1e-5 * np.abs(g_ref).max()) & (
                np.abs(grads[0][k] - g_ref) > 1e-2 * np.abs(g_ref))
            if mask.any():
                exempt[(part, k)] = exempt.get((part, k), False) | mask
    got = jax.tree_util.tree_map(np.array, got)
    ref = jax.tree_util.tree_map(np.array, ref)
    for (part, key), mask in exempt.items():
        for now, prev in ((got, prev_got), (ref, prev_ref)):
            moved = np.abs(_leaves(now[part]['params'])[key]
                           - _leaves(prev[part]['params'])[key])
            assert moved[mask].max() <= 2 * lrs[part] + 1e-9, (part, key)
        for tree in (got, ref):
            flat, treedef = jax.tree_util.tree_flatten_with_path(
                tree[part]['params'])
            tree[part]['params'] = jax.tree_util.tree_unflatten(
                treedef, [np.where(mask, 0.0, v)
                          if jax.tree_util.keystr(p) == key else v
                          for p, v in flat])
    assert_trees(got, ref, tol)
    return sum(int(m.sum()) for m in exempt.values())


def assert_metrics(got, ref, tol):
    assert set(got) == set(ref)
    for k in ref:
        if k == 'finite':
            assert bool(got[k]) == bool(ref[k])
        else:
            np.testing.assert_allclose(float(got[k]), float(ref[k]),
                                       rtol=tol, atol=tol, err_msg=k)


# ----------------------------------------------------------- predictors
def predictor_cfgs():
    return {'rgb': jcfg_mod.PredictorConfig(style_dim=64, hidden_dim=32),
            'curliness': dataclasses.replace(
                jcfg_mod.curliness_predictor_config(), style_dim=64,
                hidden_dim=16)}


def predictor_batch(which, seed, n=32, nan=False):
    rng = np.random.default_rng(seed)
    code = rng.standard_normal((n, 64)).astype(np.float32)
    if nan:
        code[3, 5] = np.nan
    batch = {'code': code}
    if which == 'curliness':
        batch['curliness_label'] = np.where(
            code[:, :1] + code[:, 1:2] > 0, 1.0, -1.0).astype(np.float32)
    else:
        batch['rgb_mean'] = code[:, :3] * 40 + 128
        batch['pca_std'] = np.abs(code[:, 3:4]) * 30 + 20
    return batch


def jax_dropout_masks(cfg, variables, code, rng):
    """The keep masks flax's Dropout layers drew for this rng: a unit is
    kept where the dropout output is nonzero."""
    model = JaxPredictor(cfg, train=True)
    _, inter = model.apply(variables, {'code': jnp.asarray(code)},
                           rngs={'dropout': rng},
                           mutable=['batch_stats', 'intermediates'],
                           capture_intermediates=True)
    net = inter['intermediates']['net']
    return [torch.tensor(np.asarray(
        net[f'layer_{i}']['Dropout_0']['__call__'][0]) != 0)
        for i in range(cfg.hidden_layer_num)]


def shadowed_layers(cfg):
    """Hidden layers whose fc bias feeds a batch-statistics BatchNorm."""
    return [f'layer_{i}' for i in range(cfg.hidden_layer_num)] \
        if cfg.norm == 'bn' else []


def run_predictor(which, steps, nan_at=None):
    cfg = predictor_cfgs()[which]
    jtr = JaxPredictorTrainer(cfg)
    jstate = jtr.init_state(jax.random.PRNGKey(0))
    ptr = PredictorTrainer(port_cfg(cfg), device='cpu')
    pstate = ptr.init_state()
    pstate.load_tree(state_dict(jstate))
    assert_trees(pstate.to_tree(), state_dict(jstate), 0)
    for step in range(steps):
        batch = predictor_batch(which, 10 + step, nan=step == nan_at)
        rng = jax.random.PRNGKey(100 + step)
        variables = dict(jstate.model.params, batch_stats=jstate.stats)
        masks = jax_dropout_masks(cfg, variables, batch['code'], rng)
        before = state_dict(jstate)
        jstate, jm = jtr.train_step(
            jstate, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
        pstate, pm = ptr.train_step(pstate, to_torch(batch),
                                    {'dropout': masks})
        yield step, jstate, jm, pstate, pm, before, (jtr, ptr, batch)


def net_of(tree, *path):
    for p in path:
        tree = tree[p]
    return tree['net']


def check_predictor_states(cfg, got, ref, tol, history):
    """got / ref: the two state trees; history: (port tree, JAX tree) at
    the start and after each step so far.  See the header for the biases
    a batch-statistics BatchNorm shadows."""
    got = jax.tree_util.tree_map(np.asarray, got)
    ref = jax.tree_util.tree_map(np.asarray, ref)
    k_steps = len(history) - 1
    for name in shadowed_layers(cfg):
        for tree in (got, ref):
            mu = net_of(tree, 'model', 'opt_state', '0', 'mu', 'params')
            top = max(np.abs(x).max() for x in
                      jax.tree_util.tree_leaves(mu))
            assert np.abs(mu[name]['fc']['bias']).max() <= 1e-5 * top
        biases = [[net_of(t, 'model', 'params', 'params')[name]['fc']['bias']
                   for t in side] for side in zip(*history)]
        for side in biases:
            for a, b in zip(side, side[1:]):
                assert np.abs(a - b).max() <= 2 * cfg.lr   # Adam's bound
        # the running mean: JAX's plus the offset the bias histories give
        offset = sum(0.1 * 0.9 ** (k_steps - 1 - s)
                     * (biases[0][s] - biases[1][s]) for s in range(k_steps))
        rm_got = net_of(got, 'stats')[name]['norm']['bn']['mean']
        rm_ref = net_of(ref, 'stats')[name]['norm']['bn']['mean']
        np.testing.assert_allclose(rm_got - offset, rm_ref, rtol=tol,
                                   atol=tol, err_msg=name)
        for tree in (got, ref):
            net_of(tree, 'model', 'params', 'params')[name]['fc']['bias'] = \
                np.zeros(1)
            net_of(tree, 'stats')[name]['norm']['bn']['mean'] = np.zeros(1)
    assert_trees(got, ref, tol)


@pytest.mark.parametrize('which', ['rgb', 'curliness'])
def test_predictor_one_and_three_steps(which):
    cfg = predictor_cfgs()[which]
    history = None
    for step, jstate, jm, pstate, pm, before, _ in run_predictor(which, 3):
        if history is None:
            history = [(before, before)]
        tol = ONE_STEP if step == 0 else THREE_STEPS
        assert bool(jm['finite']) and bool(pm['finite'])
        assert_metrics(pm, jm, tol)
        history.append((pstate.to_tree(), state_dict(jstate)))
        check_predictor_states(cfg, *history[-1], tol, history)


def test_predictor_batch_stats_and_eval():
    """BatchNorm's running statistics after a step are flax's (momentum
    0.9 on the biased batch variance), and eval_metrics of one state (JAX's
    after the step, loaded into the port) agrees, test/accuracy too."""
    for which in ('rgb', 'curliness'):
        for _, jstate, _, pstate, _, before, (jtr, ptr, batch) in \
                run_predictor(which, 1):
            got = pstate.to_tree()['stats']
            assert_trees(got, jax.device_get(jstate.stats), ONE_STEP)
            # they moved, and not by torch's unbiased rule
            var = got['net']['layer_0']['norm']['bn']['var']
            assert not np.allclose(
                var, before['stats']['net']['layer_0']['norm']['bn']['var'])
            pstate.load_tree(state_dict(jstate))
            jev = jtr.eval_metrics(
                jstate.model.params, jstate.stats,
                {k: jnp.asarray(v) for k, v in batch.items()})
            pev = ptr.eval_metrics(pstate, to_torch(batch))
            assert ('test/accuracy' in pev) == (which == 'curliness')
            assert_metrics(pev, jev, ONE_STEP)


@pytest.mark.parametrize('which', ['rgb', 'curliness'])
def test_predictor_nan_batch_leaves_state(which):
    cfg = predictor_cfgs()[which]
    history = None
    for step, jstate, jm, pstate, pm, before, _ in run_predictor(
            which, 2, nan_at=1):
        if history is None:
            history = [(before, before)]
        if step == 0:
            history.append((pstate.to_tree(), state_dict(jstate)))
            continue
        assert not bool(jm['finite']) and not bool(pm['finite'])
        after = state_dict(jstate)
        assert int(after['step']) == int(before['step']) + 1
        after['step'] = before['step']
        assert_trees(after, before, 0)
        mine = pstate.to_tree()
        assert int(mine['step']) == 2
        mine['step'] = before['step']
        assert_trees(mine, history[-1][0] | {'step': before['step']}, 0)
        check_predictor_states(cfg, mine, before, ONE_STEP, history)
    # the port alone: a NaN step changes nothing, bit for bit
    cfg = port_cfg(predictor_cfgs()[which])
    ptr = PredictorTrainer(cfg, device='cpu')
    pstate = ptr.init_state(seed=1)
    ptr.train_step(pstate, to_torch(predictor_batch(which, 1)))
    before = pstate.to_tree()
    _, m = ptr.train_step(pstate, to_torch(predictor_batch(which, 2,
                                                           nan=True)))
    assert not bool(m['finite'])
    after = pstate.to_tree()
    after['step'] = before['step']
    assert_trees(after, before, 0)


# -------------------------------------------------------- colour/texture
def jax_draws(rng, n, prob):
    """The draws of JAX's _train_step(rng) / _forward(k_fwd)."""
    k_fwd, k_gp, k_gp_noise = jax.random.split(rng, 3)
    k1, k2, k3, k_enc = jax.random.split(k_fwd, 4)
    t = lambda x: torch.tensor(np.asarray(x))
    return {'p1': t(jax.random.permutation(k1, n)).long(),
            'p2': t(jax.random.permutation(k2, n)).long(),
            'p3': t(jax.random.permutation(k3, n)).long(),
            'use_enc': t(jax.random.bernoulli(k_enc, prob)),
            'alpha_gp': t(jax.random.uniform(k_gp, (n, 1), jnp.float32)),
            'alpha_gp_noise': t(jax.random.uniform(k_gp_noise, (n, 1),
                                                   jnp.float32))}


def ct_batch(cfg, seed, n, rec_img, nan=False):
    batch = {k: np.asarray(v) for k, v in
             jax_ct_batch(jax.random.PRNGKey(seed), cfg, n).items()}
    if rec_img:
        rng = np.random.default_rng(seed)
        batch['sean_code'] = rng.standard_normal((n, 19, 64)).astype(
            np.float32)
        batch['label'] = rng.integers(0, 19, (n, 32, 32)).astype(np.int32)
        batch['image'] = (rng.standard_normal((n, 32, 32, 3)) * 0.3).astype(
            np.float32)
    if nan:
        batch['code'] = batch['code'].copy()
        batch['code'][1, 2] = np.nan
    return batch


def run_ct(rec_img, steps, nan_at=None, n=8):
    cfg = TINY_CT
    sean = sean_params = port_sean = None
    if rec_img:
        cfg = dataclasses.replace(cfg, lambda_rec_img={0: 10.0})
        sean = JaxSEAN(TINY_SEAN)
        sean_params = sean.init(jax.random.PRNGKey(0),
                                jnp.zeros((1, 32, 32, 3)),
                                jnp.zeros((1, 32, 32), jnp.int32))
        port_sean = SEAN(port_cfg(TINY_SEAN))
        load_variables(port_sean, 'sean', jax.device_get(sean_params))
    jtr = JaxCTTrainer(cfg, sean=sean, sean_params=sean_params)
    jstate, jpred = jtr.init_state(jax.random.PRNGKey(0))
    ptr = ColorTextureTrainer(port_cfg(cfg), sean=port_sean, device='cpu')
    pstate, ppred = ptr.init_state()
    pstate.load_tree(state_dict(jstate))
    for k in ('rgb', 'curliness'):
        load_variables(ppred[k], k, jax.device_get(jpred[k]))
    for step in range(steps):
        batch = ct_batch(cfg, 20 + step, n, rec_img, nan=step == nan_at)
        rng = jax.random.PRNGKey(200 + step)
        draws = jax_draws(rng, n, cfg.gan_input_from_encoder_prob)
        before = state_dict(jstate)
        jstate, jm = jtr.train_step(
            jstate, {k: jnp.asarray(v) for k, v in batch.items()}, jpred,
            rng)
        pstate, pm = ptr.train_step(pstate, to_torch(batch), ppred, draws)
        yield step, jstate, jm, pstate, pm, before


@pytest.mark.parametrize('rec_img', [False, True])
def test_ct_one_and_three_steps(rec_img):
    for step, jstate, jm, pstate, pm, _ in run_ct(rec_img, 3):
        tol = ONE_STEP if step == 0 else THREE_STEPS
        assert bool(jm['finite']) and bool(pm['finite'])
        assert ('g/lambda_rec_img' in pm) == rec_img
        assert_metrics(pm, jm, tol)
        assert_trees(pstate.to_tree(), state_dict(jstate), tol)


def test_ct_nan_batch_leaves_state():
    for step, jstate, jm, pstate, pm, before in run_ct(False, 2, nan_at=1):
        if step == 1:
            assert not bool(jm['finite']) and not bool(pm['finite'])
            after = state_dict(jstate)
            after['step'] = before['step']
            assert_trees(after, before, 0)
    # the port alone, bit for bit
    cfg = port_cfg(TINY_CT)
    ptr = ColorTextureTrainer(cfg, device='cpu')
    pstate, ppred = ptr.init_state(seed=3)
    gen = torch.Generator().manual_seed(0)
    ptr.train_step(pstate, synthetic_batch(gen, cfg, 8), ppred)
    before = pstate.to_tree()
    bad = synthetic_batch(gen, cfg, 8)
    bad['code'][0, 0] = float('nan')
    _, m = ptr.train_step(pstate, bad, ppred)
    assert not bool(m['finite'])
    after = pstate.to_tree()
    assert int(after['step']) == int(before['step']) + 1
    after['step'] = before['step']
    assert_trees(after, before, 0)


def test_synthetic_batch_contract():
    """Keys, shapes and ranges of JAX's synthetic_batch."""
    cfg = port_cfg(TINY_CT)
    got = synthetic_batch(torch.Generator().manual_seed(0), cfg, 64)
    ref = jax_ct_batch(jax.random.PRNGKey(0), TINY_CT, 64)
    assert set(got) == set(ref)
    for k in ref:
        assert tuple(got[k].shape) == ref[k].shape, k
        assert got[k].dtype == torch.float32
    assert 0 <= float(got['rgb_mean'].min()) and \
        float(got['rgb_mean'].max()) < 255
    assert 20 <= float(got['pca_std'].min()) and \
        float(got['pca_std'].max()) < 120
    assert set(np.unique(got['curliness_label'].numpy())) == {-1.0, 1.0}
    assert bool((torch.sign(got['noise_curliness'])
                 == got['curliness_label']).all())
