# The port's slice end to end against the JAX editor on the same weights:
# image -> analysis (labels, SEAN codes, Latent) -> output / output_refresh
# / output_sweep, uint8 images compared pixel by pixel.
#
# Tolerances.  Labels are argmaxes, equal on >= 99.9% of pixels (a float32
# near-tie may flip).  Codes and latents: atol 1e-4 * max|ref|, as in
# test_torch_models.py (XLA:CPU and torch sum in other orders); hsv within 1
# step (it is round() of a float colour).  Images: within 1 uint8 step on
# >= 99.9% of pixels and mean |diff| <= 0.05 (rounding of values that land
# near .5, the JAX package's own bar for its Pallas blend).  The port's
# bfloat16 run is held to its float32 run at mean |diff| <= 3 steps.
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctrlhair_tpu.constants import HAIR_IDX, NUM_CLASSES
from ctrlhair_tpu_torch.convert import from_flax
from ctrlhair_tpu_torch.ops.poisson_pallas import MASKED_CG
from ctrlhair_tpu_torch.pipeline import editor as port_editor
from ctrlhair_tpu_torch.pipeline.editor import HairEditor
from ctrlhair_tpu_torch.pipeline.latent import Latent
from conftest import tiny_pipeline_cfg
from test_torch_convert import port_config

FIELDS = [f.name for f in dataclasses.fields(Latent)]


def smooth_image(rng, size):
    small = rng.uniform(0, 255, (size // 8, size // 8, 3))
    img = np.kron(small, np.ones((8, 8, 1))) + rng.normal(0, 6, (size,) * 2
                                                           + (3,))
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def to_port_latent(jl) -> Latent:
    return Latent(**{f: torch.tensor(np.asarray(getattr(jl, f)))
                     for f in FIELDS})


def close(got, ref):
    ref = np.asarray(ref, np.float32)
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-4 * float(np.abs(ref).max()))


def images_agree(got, ref):
    d = np.abs(got.numpy().astype(np.int32) - np.asarray(ref).astype(
        np.int32))
    assert got.dtype == torch.uint8 and d.shape == np.asarray(ref).shape
    assert (d <= 1).mean() >= 0.999, (d <= 1).mean()
    assert d.mean() <= 0.05, d.mean()


@pytest.fixture(scope='module')
def port(tiny_editor):
    ed = HairEditor(port_config(tiny_editor.cfg), device='cpu')
    ed.load_state_dict(from_flax(jax.device_get(tiny_editor.params)))
    return ed


@pytest.fixture(scope='module')
def analyses(tiny_editor, port):
    """One seeded image at the parser's input size, so each side's
    _to_parse_size is the identity and the edit-size image comes from the
    same bilinear resize on both sides."""
    img = smooth_image(np.random.default_rng(11),
                       tiny_editor.cfg.bisenet.input_size)
    return img, tiny_editor.analyze_image(img), port.analyze_image(img)


@pytest.fixture(scope='module')
def session(tiny_editor, analyses):
    """A face at the edit size and an edited latent, from the JAX analysis."""
    _, ja, _ = analyses
    rng = np.random.default_rng(12)
    face = smooth_image(rng, tiny_editor.cfg.edit_size)[None]
    lat = ja['latent']
    edited = lat.replace(texture=lat.texture + 0.8,
                         shape=lat.shape + 0.3,
                         hsv=jnp.asarray([[20.0, 150.0, 120.0]]),
                         pca_std=lat.pca_std + 5.0)
    return face, lat, edited


def test_analyze_labels_agree(analyses):
    _, ja, ta = analyses
    for key in ('label512', 'label', 'regen_label'):
        eq = (ta[key].numpy() == np.asarray(ja[key])).mean()
        assert eq >= 0.999, (key, eq)


def test_analyze_codes_and_latent(analyses):
    _, ja, ta = analyses
    jl, tl = np.asarray(ja['label']), ta['label'].numpy()
    # the seeded image parses to some hair, so the hair code and every
    # latent field drawn from it are computed from real pixels
    assert (jl == HAIR_IDX).sum() > 0
    # codes of the regions whose label masks agree exactly
    same = [r for r in range(NUM_CLASSES)
            if np.array_equal(jl == r, tl == r)]
    assert HAIR_IDX in same
    close(ta['sean_codes'][:, same], np.asarray(ja['sean_codes'])[:, same])
    close(ta['hair_feature'], ja['hair_feature'])
    # colour, texture and curliness depend on the hair code alone
    for f in ('pca_std', 'curliness', 'texture'):
        close(getattr(ta['latent'], f), getattr(ja['latent'], f))
    np.testing.assert_allclose(ta['latent'].hsv.numpy(),
                               np.asarray(ja['latent'].hsv), atol=1.0)
    # shape and face codes encode the whole label: this image's labels agree
    # on every pixel
    np.testing.assert_array_equal(tl, jl)
    for f in ('shape', 'face'):
        close(getattr(ta['latent'], f), getattr(ja['latent'], f))
    for f in FIELDS:
        assert getattr(ta['latent'], f).dtype == torch.float32


def test_output_matches_jax(tiny_editor, port, analyses, session):
    _, ja, _ = analyses
    face, _, edited = session
    ref = tiny_editor.output(tiny_editor.params, ja['sean_codes'], edited,
                             jnp.asarray(face), ja['label'],
                             ja['regen_label'])
    got = port.output(np.asarray(ja['sean_codes']), to_port_latent(edited),
                      face, np.asarray(ja['label']),
                      np.asarray(ja['regen_label']))
    images_agree(got, ref)


def test_output_refresh_matches_jax(tiny_editor, port, analyses, session):
    _, ja, _ = analyses
    face, _, edited = session
    ref_img, ref_label = tiny_editor.output_refresh(
        tiny_editor.params, ja['sean_codes'], edited, jnp.asarray(face),
        ja['label'])
    got_img, got_label = port.output_refresh(
        np.asarray(ja['sean_codes']), to_port_latent(edited), face,
        np.asarray(ja['label']))
    assert (got_label.numpy() == np.asarray(ref_label)).mean() >= 0.999
    images_agree(got_img, ref_img)


def test_output_sweep_matches_jax(tiny_editor, port, analyses, session):
    _, ja, _ = analyses
    face, lat, edited = session
    alphas = np.asarray([0.0, 0.4, 1.0], np.float32)
    ref = tiny_editor.output_sweep(
        tiny_editor.params, ja['sean_codes'], lat, edited,
        jnp.asarray(alphas), jnp.asarray(face), ja['label'],
        ja['regen_label'])
    got = port.output_sweep(
        np.asarray(ja['sean_codes']), to_port_latent(lat),
        to_port_latent(edited), alphas, face, np.asarray(ja['label']),
        np.asarray(ja['regen_label']))
    assert got.shape[0] == 3
    images_agree(got, ref)


def test_cpu_path_launches_no_kernel(port, analyses, session):
    _, ja, _ = analyses
    face, lat, _ = session
    before = MASKED_CG.launches
    port.output(np.asarray(ja['sean_codes']), to_port_latent(lat), face,
                np.asarray(ja['label']), np.asarray(ja['regen_label']))
    assert MASKED_CG.launches == before


def test_parse_resizes_like_jax(tiny_editor, port):
    """An input off the parser's size goes through the same bilinear
    resize and re-quantisation on both sides."""
    img = smooth_image(np.random.default_rng(13), 96)[None]
    ref = tiny_editor.parse(tiny_editor.params, jnp.asarray(img))
    got = port.parse(img)
    assert got.shape == ref.shape
    assert (got.numpy() == np.asarray(ref)).mean() >= 0.999


def test_bfloat16_run_close_to_float32(tiny_editor, port, analyses,
                                       session):
    cfg = dataclasses.replace(port.cfg, compute_dtype='bfloat16')
    bf16 = HairEditor(cfg, device='cpu')
    bf16.load_state_dict(port.state_dict())
    img, ja, _ = analyses
    face, _, edited = session
    args = (np.asarray(ja['sean_codes']), to_port_latent(edited), face,
            np.asarray(ja['label']), np.asarray(ja['regen_label']))
    ref = port.output(*args).numpy().astype(np.int32)
    got = bf16.output(*args).numpy().astype(np.int32)
    assert np.abs(got - ref).mean() <= 3.0
    a = bf16.analyze_image(img)          # the whole slice runs in bf16
    assert a['sean_codes'].dtype == torch.float32
    assert torch.isfinite(a['sean_codes']).all()
    assert a['latent'].face.dtype == torch.float32


def test_style_fallback(tiny_editor, port, tmp_path):
    d = tiny_editor.cfg.sean.style_dim
    ed = HairEditor(port.cfg, device='cpu')
    ed.load_state_dict(port.state_dict())
    rng = np.random.default_rng(14)
    codes = rng.standard_normal((NUM_CLASSES, d)).astype(np.float32)
    for i in (0, 5, HAIR_IDX):
        (tmp_path / str(i)).mkdir()
        np.save(tmp_path / str(i) / 'ACE.npy', codes[i])
    (tmp_path / '7').mkdir()
    np.save(tmp_path / '7' / 'ACE.npy', np.zeros(d + 1, np.float32))
    with pytest.warns(UserWarning, match='shape'):
        ed.load_style_fallback(str(tmp_path))
    want = np.zeros_like(codes)
    want[[0, 5, HAIR_IDX]] = codes[[0, 5, HAIR_IDX]]
    np.testing.assert_array_equal(ed.style_fallback.numpy(), want)
    # rendering with absent codes takes the fallback, as in the JAX editor
    label = np.zeros((1, 64, 64), np.int32)
    label[:, 20:40] = HAIR_IDX
    sean_codes = np.zeros((1, NUM_CLASSES, d), np.float32)
    sean_codes[0, 5] = 1.0
    ref = tiny_editor.render(
        dict(tiny_editor.params, style_fallback=jnp.asarray(want)),
        jnp.asarray(sean_codes), jnp.asarray(label))
    with torch.inference_mode():
        got = ed._render(torch.tensor(sean_codes), torch.tensor(label))
    close(got, ref)


def test_no_plain_blend_path():
    """The JAX config's switch to its XLA CG blend has no counterpart: the
    port refuses it rather than go round the kernel."""
    cfg = dataclasses.replace(port_config(tiny_pipeline_cfg()),
                              use_pallas_blend=False)
    with pytest.raises(ValueError, match='use_pallas_blend'):
        HairEditor(cfg, device='cpu')


def test_no_card_no_silent_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        port_editor.resolve_device(None)
    with pytest.raises(RuntimeError):
        port_editor.resolve_device('cuda')
    with pytest.raises(RuntimeError):
        HairEditor(port_config(tiny_pipeline_cfg()))
