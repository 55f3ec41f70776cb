# The port's Adam and finite guard (ctrlhair_tpu_torch/training/
# train_state.py) against optax / the JAX package's safe_apply_updates on
# the same parameters and gradients: a constant rate and a {step: lr}
# schedule over several updates, one of them non-finite, which must leave
# parameters, both moments and the count bit-identical on both sides; and
# the ModelOpt tree against flax's state dict of the JAX ModelOpt.
# Bar: 1e-6 relative + 1e-7 absolute after each update (float32).
import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctrlhair_tpu.training.train_state import (
    ModelOpt as JaxModelOpt, adam as jax_adam, grads_finite as jax_finite,
    safe_apply_updates as jax_apply)
from ctrlhair_tpu_torch.convert import to_flax
from ctrlhair_tpu_torch.models.layers import MLP, init_parameters_
from ctrlhair_tpu_torch.training.train_state import (
    ModelOpt, adam, grads_finite, safe_apply_updates)


def leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def assert_trees(got, ref, rtol=1e-6, atol=1e-7):
    """Same structure; every leaf close (bit-equal when rtol=atol=0)."""
    g, r = (jax.tree_util.tree_flatten_with_path(t)[0] for t in (got, ref))
    assert [p for p, _ in g] == [p for p, _ in r]
    for (path, a), (_, b) in zip(g, r):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, path
        if rtol == atol == 0:
            np.testing.assert_array_equal(a, b, err_msg=str(path))
        else:
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol,
                                       err_msg=str(path))


@pytest.mark.parametrize('lr', [3e-3, {0: 1e-2, 2: 5e-3, 4: 1e-3}])
def test_adam_and_finite_guard_match_optax(lr):
    torch.manual_seed(0)
    module = MLP(6, 8, 2, 3, norm='none')
    init_parameters_(module, torch.Generator().manual_seed(0))
    opt = ModelOpt(module, adam(lr, 0.5, 0.999), 'm')
    tx = jax_adam(lr, 0.5, 0.999)
    jstate = JaxModelOpt.create(
        jax.tree_util.tree_map(jnp.asarray, to_flax(module, 'm')), tx)
    assert_trees(opt.to_tree(), flax.serialization.to_state_dict(jstate),
                 0, 0)
    rng = np.random.default_rng(1)
    names = [k for k, _ in module.named_parameters()]
    for step in range(7):
        grads = {k: rng.standard_normal(tuple(p.shape)).astype(np.float32)
                 * 10.0 ** rng.integers(-4, 2)
                 for k, p in module.named_parameters()}
        if step == 3:                            # one non-finite update
            grads[names[1]][0] = np.nan
        before = opt.to_tree()
        tg = [torch.tensor(grads[k]) for k in names]
        finite = grads_finite(tg)
        safe_apply_updates(opt, tg, finite)
        jg = jax.tree_util.tree_map(jnp.asarray, to_flax(
            module, 'm', {k: torch.tensor(v) for k, v in grads.items()}))
        jfin = jax_finite(jg)
        assert bool(finite) == bool(jfin) == (step != 3)
        jstate = jax_apply(jstate, jg, tx, jfin)
        ref = flax.serialization.to_state_dict(jstate)
        if step == 3:
            assert_trees(opt.to_tree(), before, 0, 0)
        assert_trees(opt.to_tree(), ref)
    assert int(opt.count) == 6
    if isinstance(lr, dict):
        lrs = [float(opt.tx.lr_at(torch.tensor(c, dtype=torch.int32)))
               for c in range(6)]
        np.testing.assert_allclose(lrs, [1e-2, 1e-2, 5e-3, 5e-3, 1e-3,
                                         1e-3], rtol=1e-7)


def test_nan_step_is_bit_identical_on_both_sides():
    module = MLP(4, 5, 1, 2)
    init_parameters_(module, torch.Generator().manual_seed(2))
    opt = ModelOpt(module, adam(1e-3), 'm')
    tx = jax_adam(1e-3)
    jstate = JaxModelOpt.create(
        jax.tree_util.tree_map(jnp.asarray, to_flax(module, 'm')), tx)
    # one good update first, so the moments are not zero
    g = [torch.full_like(p, 0.5) for p in module.parameters()]
    safe_apply_updates(opt, g, grads_finite(g))
    jg = jax.tree_util.tree_map(lambda x: jnp.full_like(x, 0.5),
                                jstate.params)
    jstate = jax_apply(jstate, jg, tx, jax_finite(jg))
    port_before = opt.to_tree()
    jax_before = flax.serialization.to_state_dict(jstate)
    bad = [torch.full_like(p, np.inf) for p in module.parameters()]
    safe_apply_updates(opt, bad, grads_finite(bad))
    jbad = jax.tree_util.tree_map(lambda x: jnp.full_like(x, jnp.inf),
                                  jstate.params)
    jstate = jax_apply(jstate, jbad, tx, jax_finite(jbad))
    assert_trees(opt.to_tree(), port_before, 0, 0)
    assert_trees(flax.serialization.to_state_dict(jstate), jax_before, 0, 0)
    assert int(opt.count) == 1


def test_model_opt_tree_round_trip():
    """load_tree(to_tree()) restores parameters, moments and count."""
    module = MLP(4, 5, 2, 2, norm='bn')
    init_parameters_(module, torch.Generator().manual_seed(3))
    opt = ModelOpt(module, adam({0: 1e-3, 3: 1e-4}), 'm')
    g = [torch.randn(p.shape, generator=torch.Generator().manual_seed(4))
         for p in module.parameters()]
    safe_apply_updates(opt, g, grads_finite(g))
    tree = opt.to_tree()
    assert set(tree['opt_state']['1']) == {'count'}
    other = MLP(4, 5, 2, 2, norm='bn')
    init_parameters_(other, torch.Generator().manual_seed(9))
    fresh = ModelOpt(other, adam({0: 1e-3, 3: 1e-4}), 'm')
    fresh.load_tree(tree)
    assert_trees(fresh.to_tree(), tree, 0, 0)
