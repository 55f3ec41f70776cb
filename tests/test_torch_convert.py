# The weight bridge of the PyTorch port: every leaf of the JAX editor's
# parameter tree lands in the port's HairEditor with the layout rules of
# ctrlhair_tpu_torch/convert.py, and a Conv and a ConvTranspose carried
# across compute what jax.lax computes with the flax kernel.
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctrlhair_tpu_torch import config as port_cfg_mod
from ctrlhair_tpu_torch.convert import CONV_TRANSPOSE_PATHS, from_flax
from ctrlhair_tpu_torch.models.layers import TorchConv, TorchConvTranspose
from ctrlhair_tpu_torch.pipeline.editor import HairEditor


FAMILIES = ['sean', 'bisenet', 'shape', 'ct_gen', 'ct_dis', 'rgb_pred',
            'curliness_pred']


def port_config(jcfg):
    """The port's PipelineConfig with the same field values as the JAX
    one (the port keeps its own copy of the dataclasses)."""
    kw = {}
    for f in dataclasses.fields(jcfg):
        v = getattr(jcfg, f.name)
        if dataclasses.is_dataclass(v):
            cls = getattr(port_cfg_mod, type(v).__name__)
            v = cls(**{g.name: getattr(v, g.name)
                       for g in dataclasses.fields(v)})
        kw[f.name] = v
    return port_cfg_mod.PipelineConfig(**kw)


def flax_leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flax_leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


@pytest.fixture(scope='module')
def jax_params(tiny_editor):
    return jax.device_get(tiny_editor.params)


@pytest.fixture(scope='module')
def port(tiny_editor, jax_params):
    ed = HairEditor(port_config(tiny_editor.cfg), device='cpu')
    ed.load_state_dict(from_flax(jax_params))   # strict: no missing leaf
    return ed


def expected(path, value):
    """(torch key, torch value) by the documented layout rules."""
    family, collection, *mods, leaf = path
    value = np.asarray(value, np.float32)
    if collection == 'batch_stats':
        name = {'mean': 'running_mean', 'var': 'running_var'}[leaf]
    elif leaf == 'kernel' and value.ndim == 2:
        name, value = 'weight', value.T
    elif leaf == 'kernel' and tuple([family] + mods) in CONV_TRANSPOSE_PATHS:
        # torch ConvTranspose2d [in,out,kh,kw] is the flax kernel flipped
        name = 'weight'
        value = np.flip(value, (0, 1)).transpose(2, 3, 0, 1)
    elif leaf == 'kernel':
        name, value = 'weight', value.transpose(3, 2, 0, 1)
    elif leaf == 'scale':
        name = 'weight'
    else:
        name = leaf
    return '.'.join([family] + mods + [name]), value


@pytest.mark.parametrize('family', FAMILIES)
def test_every_leaf_lands(family, jax_params, port):
    state = port.state_dict()
    seen = set()
    for path, value in flax_leaves(jax_params[family]):
        key, want = expected((family,) + path, value)
        assert key in state, key
        np.testing.assert_array_equal(state[key].numpy(), want, err_msg=key)
        seen.add(key)
    # and the port holds nothing the flax tree lacks
    assert {k for k in state if k.startswith(family + '.')} == seen


def test_style_fallback_lands(jax_params, port):
    np.testing.assert_array_equal(port.style_fallback.numpy(),
                                  np.asarray(jax_params['style_fallback']))


def test_unknown_and_missing_leaves_raise(jax_params, port):
    bad = dict(jax_params, ct_gen={'params': dict(
        jax_params['ct_gen']['params'], extra={'foo': np.zeros(3)})})
    with pytest.raises(KeyError):
        from_flax(bad)
    state = from_flax(jax_params)
    state.pop('ct_gen.main_in.weight')
    with pytest.raises(RuntimeError, match='Missing'):
        port.load_state_dict(state)


def test_conv_layouts_compute_like_lax(jax_params, port):
    """One Conv and one ConvTranspose, numerically against jax.lax."""
    rng = np.random.default_rng(0)
    z = jax_params['sean']['params']['zencoder']

    # Conv: down_0 (3x3, stride 2, pad 1)
    k = z['down_0']['conv']['kernel']
    x = rng.standard_normal((2, 16, 16, k.shape[2])).astype(np.float32)
    ref = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(k), (2, 2), [(1, 1), (1, 1)],
        dimension_numbers=('NHWC', 'HWIO', 'NHWC'),
        precision=jax.lax.Precision.HIGHEST) + z['down_0']['conv']['bias']
    conv = port.sean.zencoder.down_0
    assert isinstance(conv, TorchConv)
    got = conv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)

    # ConvTranspose: up_0 as flax computes it (lax.conv_transpose with the
    # torch-equivalent padding (k-1-p, k-1-p+output_padding))
    k = z['up_0']['conv']['kernel']
    x = rng.standard_normal((2, 8, 8, k.shape[2])).astype(np.float32)
    ref = jax.lax.conv_transpose(
        jnp.asarray(x), jnp.asarray(k), (2, 2), [(1, 2), (1, 2)],
        dimension_numbers=('NHWC', 'HWIO', 'NHWC'),
        precision=jax.lax.Precision.HIGHEST) + z['up_0']['conv']['bias']
    up = port.sean.zencoder.up_0
    assert isinstance(up, TorchConvTranspose)
    got = up(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == ref.shape == (2, 16, 16, k.shape[3])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_init_draws_from_the_flax_distributions(tiny_editor, jax_params):
    """The port's own init (its generator, its numbers) has the scales of
    the flax initialisers, leaf by leaf."""
    ed = HairEditor(port_config(tiny_editor.cfg), device='cpu', seed=3)
    state = ed.state_dict()
    checked = 0
    for family in FAMILIES:
        for path, value in flax_leaves(jax_params[family]):
            key, ref = expected((family,) + path, value)
            got = state[key].numpy()
            if not ref.any():
                assert not got.any(), key          # zeros stay zeros
            elif path[-1] in ('mean', 'var', 'scale', 'L'):
                np.testing.assert_array_equal(got, ref, err_msg=key)
            elif ref.size >= 256:
                ratio = got.std() / ref.std()
                assert 0.8 < ratio < 1.25, (key, ratio)
                assert np.abs(got).max() <= np.abs(ref).max() * 1.25, key
                checked += 1
    assert checked > 50
    u = ed.ct_gen.subspace_0.U.numpy()
    np.testing.assert_allclose(u @ u.T, np.eye(u.shape[0]), atol=1e-5)
    assert not ed.style_fallback.any()
