# The port's validation canvases (ctrlhair_tpu_torch/training/
# validation.py) against the JAX package's, on the shared tiny editor's
# weights (tests/conftest.py) and the analysis of one random image, JAX's
# codes and label map handed to both sides.  Bar: every canvas within one
# uint8 step of JAX's on >= 99.9% of its pixels (XLA:CPU and torch sum the
# renders in other orders); the shape sweep's coloured masks equal on >=
# 99.9% (argmax near-ties); a saved canvas reads back as the array
# returned.  ct_random_sample_canvas is handed the normal draws JAX made
# from its key.
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctrlhair_tpu.training import validation as jval
from ctrlhair_tpu_torch.convert import from_flax
from ctrlhair_tpu_torch.pipeline.editor import HairEditor
from ctrlhair_tpu_torch.training import validation as tval
from ctrlhair_tpu_torch.utils.image import read_rgb
from test_torch_convert import port_config


@pytest.fixture(scope='module')
def editors(tiny_editor):
    port = HairEditor(port_config(tiny_editor.cfg), device='cpu')
    port.load_state_dict(from_flax(jax.device_get(tiny_editor.params)))
    img = np.random.default_rng(0).integers(0, 255, (64, 64, 3),
                                            dtype=np.uint8)
    return tiny_editor, port, tiny_editor.analyze_image(img), img


def base_data():
    return {'noise': np.zeros((1, 8), np.float32),
            'noise_curliness': np.zeros((1, 1), np.float32),
            'rgb_mean': np.full((1, 3), 128.0, np.float32),
            'pca_std': np.full((1, 1), 50.0, np.float32)}


def canvases_agree(got, ref, bar=0.999):
    assert got.dtype == np.uint8 and got.shape == ref.shape
    d = np.abs(got.astype(np.int32) - np.asarray(ref, np.int32))
    assert (d <= 1).mean() >= bar, (d <= 1).mean()


def test_ct_latent_sweep_canvas(editors, tmp_path):
    jed, port, res, _ = editors
    codes, label = np.asarray(res['sean_codes']), np.asarray(res['label'])
    ref = jval.ct_latent_sweep_canvas(
        jed, jed.params['ct_gen'], res['sean_codes'], res['label'],
        {k: jnp.asarray(v) for k, v in base_data().items()},
        values=(-1, 0, 1))
    got = tval.ct_latent_sweep_canvas(
        port, None, codes, label, base_data(),
        out_path=str(tmp_path / 'sweep.png'), values=(-1, 0, 1))
    assert got.shape == (8 * 66 + 2, 3 * 66 + 2, 3)
    canvases_agree(got, ref)
    np.testing.assert_array_equal(read_rgb(str(tmp_path / 'sweep.png')), got)


def test_ct_random_sample_canvas(editors):
    jed, port, res, _ = editors
    rng = jax.random.PRNGKey(0)
    ref = jval.ct_random_sample_canvas(
        jed, jed.params['ct_gen'], res['sean_codes'], res['label'],
        {k: jnp.asarray(v) for k, v in base_data().items()}, rng, n=3)
    k1, k2 = jax.random.split(rng)
    draws = {'noise': torch.tensor(np.asarray(jax.random.normal(k1,
                                                                (3, 8)))),
             'noise_curliness': torch.tensor(np.asarray(
                 jax.random.normal(k2, (3, 1))))}
    got = tval.ct_random_sample_canvas(
        port, port.ct_gen, np.asarray(res['sean_codes']),
        np.asarray(res['label']), base_data(), draws)
    canvases_agree(got, ref)
    # without draws: seeded host draws, the same for the same seed
    a = tval.ct_random_sample_canvas(port, None, np.asarray(res['sean_codes']),
                                     np.asarray(res['label']), base_data(),
                                     n=2, seed=4)
    b = tval.ct_random_sample_canvas(port, None, np.asarray(res['sean_codes']),
                                     np.asarray(res['label']), base_data(),
                                     n=2, seed=4)
    np.testing.assert_array_equal(a, b)
    assert a.shape == (68, 134, 3)


def test_shape_sweep_canvas(editors):
    jed, port, res, _ = editors
    lat = res['latent']
    ref = jval.shape_sweep_canvas(jed, jed.params['shape'], lat.face,
                                  lat.shape, values=(-1, 0, 1), dims=(0, 1))
    got = tval.shape_sweep_canvas(port, None, np.asarray(lat.face),
                                  np.asarray(lat.shape), values=(-1, 0, 1),
                                  dims=(0, 1))
    assert got.shape == ref.shape
    assert (got == ref).all(-1).mean() >= 0.999


def test_transfer_matrix_canvas(editors):
    jed, port, _, img = editors
    rng = np.random.default_rng(1)
    imgs = [img, rng.integers(0, 255, (64, 64, 3), dtype=np.uint8)]
    ref = jval.transfer_matrix_canvas(jed, imgs)
    got = tval.transfer_matrix_canvas(port, imgs)
    assert got.shape == (2 * 66 + 2, 2 * 66 + 2, 3)
    canvases_agree(got, ref)
