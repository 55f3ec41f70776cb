# Each model family of the PyTorch port against its flax twin, on the same
# weights (carried across by ctrlhair_tpu_torch.convert.from_flax) and the
# same numpy inputs, at float32.
#
# Tolerance: atol = 1e-4 * max|ref|.  XLA:CPU and torch's CPU kernels sum
# the convolutions and matmuls in other orders, so float32 results differ in
# the last bits, and the deep nets (BiSeNet's 20 convs, SEAN's SPADE stack)
# carry that forward; 1e-4 of the output's range is far above that noise
# and far below any layout or semantics error.
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctrlhair_tpu.constants import HAIR_IDX
from ctrlhair_tpu.utils.masks import label_to_one_hot, split_hair_face
from ctrlhair_tpu_torch.convert import from_flax
from ctrlhair_tpu_torch.models.sean import SEAN
from ctrlhair_tpu_torch.pipeline.editor import HairEditor
from test_torch_convert import (  # noqa: F401 (autouse)
    one_torch_thread, port_config)


def T(a):
    return torch.tensor(np.asarray(a))


def jit_method(module, method):
    return jax.jit(lambda v, *a: module.apply(v, *a, method=method))


def close(got, ref):
    ref = np.asarray(ref, np.float32)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-4 * float(np.abs(ref).max()))


@pytest.fixture(scope='module')
def jp(tiny_editor):
    return jax.device_get(tiny_editor.params)


@pytest.fixture(scope='module')
def port(tiny_editor, jp):
    ed = HairEditor(port_config(tiny_editor.cfg), device='cpu')
    ed.load_state_dict(from_flax(jp))
    return ed


def _labels(rng, n, s):
    label = rng.integers(0, 19, (n, s // 8, s // 8))
    label = np.kron(label, np.ones((1, 8, 8), np.int64)).astype(np.int32)
    label[:, s // 4: s // 2, s // 4: 3 * s // 4] = HAIR_IDX
    return label


def test_bisenet_logits(tiny_editor, jp, port):
    size = tiny_editor.cfg.bisenet.input_size
    x = np.random.default_rng(0).standard_normal(
        (2, size, size, 3)).astype(np.float32)
    ref = jax.jit(tiny_editor.bisenet.apply)(jp['bisenet'], jnp.asarray(x))
    close(port.bisenet(T(x)), ref)


def test_shape_encode_decode(tiny_editor, jp, port):
    s = tiny_editor.cfg.edit_size
    label = _labels(np.random.default_rng(1), 2, s)
    hair, face = split_hair_face(label_to_one_hot(jnp.asarray(label)))
    sg = tiny_editor.shape_gen
    ref_code = jit_method(sg, sg.encode_hair)(jp['shape'], hair)
    ref_face = jit_method(sg, sg.encode_face)(jp['shape'], face)
    ref_mask = jit_method(sg, sg.decode)(jp['shape'], ref_code[1], ref_face)
    got_code = port.shape.encode_hair(T(hair))
    got_face = port.shape.encode_face(T(face))
    for g, r in zip(got_code, ref_code):
        close(g, r)
    close(got_face, ref_face)
    close(port.shape.decode(T(ref_code[1]), T(ref_face)), ref_mask)


def test_sean_encode(tiny_editor, jp, port):
    s = tiny_editor.cfg.edit_size
    rng = np.random.default_rng(2)
    img = rng.uniform(-1, 1, (2, s, s, 3)).astype(np.float32)
    label = _labels(rng, 2, s)
    sean = tiny_editor.sean
    ref = jit_method(sean, sean.encode)(jp['sean'], jnp.asarray(img),
                                        jnp.asarray(label))
    close(port.sean.encode(T(img), T(label)), ref)


def test_conv_encoder_matches_jax():
    """SEAN's VAE encoder (mu, logvar) on the same weights, carried from
    flax's tree by convert's layout rules, at a small ngf."""
    from ctrlhair_tpu.config import SEANConfig as JaxSEANConfig
    from ctrlhair_tpu.models.sean import ConvEncoder as JaxConvEncoder
    from ctrlhair_tpu_torch.config import SEANConfig
    from ctrlhair_tpu_torch.convert import load_variables, to_flax
    from ctrlhair_tpu_torch.models.sean import ConvEncoder
    kw = dict(crop_size=128, ngf=4)
    rng = np.random.default_rng(5)
    img = rng.uniform(-1, 1, (2, 128, 128, 3)).astype(np.float32)
    jenc = JaxConvEncoder(JaxSEANConfig(**kw), latent_dim=16)
    variables = jax.device_get(jenc.init(jax.random.PRNGKey(0),
                                         jnp.asarray(img[:1])))
    enc = ConvEncoder(SEANConfig(**kw), latent_dim=16)
    load_variables(enc, 'sean_encoder', variables)
    mu, logvar = enc(T(img))
    jmu, jlogvar = jax.jit(jenc.apply)(variables, jnp.asarray(img))
    for got, ref in ((mu, jmu), (logvar, jlogvar)):
        ref = np.asarray(ref)
        assert got.shape == ref.shape == (2, 16)
        np.testing.assert_allclose(got.detach().numpy(), ref, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(ref).max()))
    back = to_flax(enc, 'sean_encoder')
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(variables)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(variables)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('fold', [True, False])
def test_sean_decode(tiny_editor, jp, port, fold):
    """SEAN decode on given codes and label.  fold_style_convs=True is the
    default path; the dense path (fold=False, the same weights) must give
    the same image, the fold being exact by linearity."""
    s = tiny_editor.cfg.edit_size
    rng = np.random.default_rng(3)
    label = _labels(rng, 2, s)
    codes = rng.standard_normal(
        (2, 19, tiny_editor.cfg.sean.style_dim)).astype(np.float32) * 0.5
    sean = tiny_editor.sean
    ref = jit_method(sean, sean.decode)(jp['sean'], jnp.asarray(label),
                                        jnp.asarray(codes))
    model = port.sean
    if not fold:
        cfg = dataclasses.replace(port.cfg.sean, fold_style_convs=False)
        model = SEAN(cfg)
        model.load_state_dict(port.sean.state_dict())
    with torch.no_grad():
        close(model.decode(T(label), T(codes)), ref)


def test_color_texture_and_predictors(tiny_editor, jp, port):
    cfg = tiny_editor.cfg
    rng = np.random.default_rng(4)
    n = 3
    data = {
        'noise': rng.standard_normal((n, cfg.color_texture.noise_dim)),
        'noise_curliness': rng.standard_normal((n, 1)),
        'rgb_mean': rng.uniform(0, 255, (n, 3)),
        'pca_std': rng.uniform(0, 50, (n, 1)),
    }
    data = {k: v.astype(np.float32) for k, v in data.items()}
    ref = tiny_editor.ct_gen.apply(
        jp['ct_gen'], {k: jnp.asarray(v) for k, v in data.items()})
    close(port.ct_gen({k: T(v) for k, v in data.items()})['code'],
          ref['code'])

    code = rng.standard_normal((n, cfg.sean.style_dim)).astype(np.float32)
    for name, jmod, tmod in (
            ('ct_dis', tiny_editor.ct_dis, port.ct_dis),
            ('rgb_pred', tiny_editor.rgb_pred, port.rgb_pred),
            ('curliness_pred', tiny_editor.curliness_pred,
             port.curliness_pred)):
        ref = jmod.apply(jp[name], {'code': jnp.asarray(code)})
        got = tmod({'code': T(code)})
        assert set(got) == set(ref), name
        for key in ref:
            close(got[key], ref[key])
