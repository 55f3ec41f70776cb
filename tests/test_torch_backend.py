# The port's Backend session against the JAX Backend on the same weights:
# one scripted session (set input and target, every change_*, get_*_be2fe,
# colour / texture / shape transfer, random draws, output in its three
# branches, interpolation_sweep, output_batch, directly_change_hair_mask)
# driven through both, and the small host modules under it
# (DistTranslation, mask_to_rgb, load_directions).
#
# The photos are the real portrait samples/input.png and its mirror image.
# The weights are random, so the parser sees no face: label maps painted at
# the tiny config's parse size (tests/test_landmarks.synthetic_face) are put
# into both Backends' cached parses before the shape transfer.  Both sides
# estimate landmarks as they do by default: method='auto', which takes the
# shipped landmark net on the photos (model_trained/landmark_net).
#
# Tolerances.  Latents and slider read-backs: atol 1e-4 * max|ref| (XLA:CPU
# and torch sum in other orders); hsv within 1 step (round() of a float
# colour).  Label maps (cur_mask, warp_target): equal on >= 99.9% of pixels
# (argmax near-ties; the JAX warp rasterises on the host in double, the
# port's CPU route in float32, and the JAX session encodes the port's
# composite, see `sessions`).  uint8 images: within 1 step on >= 99.9% of
# pixels.  DistTranslation: exact table index on the value side, atol 1e-4
# on the Gaussian side (two implementations of the normal quantile).
# Landmarks: atol 1e-6 on [0,1] coordinates.
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctrlhair_tpu.constants import HAIR_IDX
from ctrlhair_tpu.pipeline import direction_finder as j_dirs
from ctrlhair_tpu.pipeline.backend import Backend as JaxBackend
from ctrlhair_tpu.utils.color_stats import DistTranslation as JaxDist
from ctrlhair_tpu.utils.image import mask_to_rgb as jax_mask_to_rgb
from ctrlhair_tpu_torch import native as port_native
from ctrlhair_tpu_torch.convert import from_flax
from ctrlhair_tpu_torch.ops import landmarks as port_landmarks
from ctrlhair_tpu_torch.ops.warp import warp_hair_mask_between_images
from ctrlhair_tpu_torch.pipeline import direction_finder as t_dirs
from ctrlhair_tpu_torch.pipeline.backend import Backend
from ctrlhair_tpu_torch.pipeline.editor import HairEditor
from ctrlhair_tpu_torch.pipeline.latent import Latent
from ctrlhair_tpu_torch.utils.color_stats import DistTranslation
from ctrlhair_tpu_torch.utils.cuda_build import HostLibrary
from ctrlhair_tpu_torch.utils.image import mask_to_rgb, read_rgb
from test_landmarks import synthetic_face
from test_torch_convert import port_config
from test_torch_editor import FIELDS

SEED = 3


def as_np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def close(got, ref, what=''):
    got, ref = as_np(got), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(
        got, ref, rtol=0, atol=1e-4 * max(float(np.abs(ref).max()), 1.0),
        err_msg=what)


def latents_close(got, ref, what):
    for f in FIELDS:
        g, r = as_np(getattr(got, f)), np.asarray(getattr(ref, f))
        if f == 'hsv':
            np.testing.assert_allclose(g, r, atol=1.0, err_msg=f'{what}.hsv')
        else:
            close(g, r, f'{what}.{f}')


def labels_agree(got, ref, what, bar=0.999):
    got, ref = as_np(got), np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    eq = (got == ref).mean()
    assert eq >= bar, (what, eq)


def images_agree(got, ref, what):
    got, ref = as_np(got), np.asarray(ref)
    assert got.dtype == np.uint8 and got.shape == ref.shape, what
    d = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    assert (d <= 1).mean() >= 0.999, (what, (d <= 1).mean())


# ----------------------------------------------------------- host modules
def test_dist_translation_matches_jax():
    rng = np.random.default_rng(0)
    table = rng.uniform(0, 255, (200, 3)).astype(np.float32)
    for tab in (table, None):                 # a table, and the default one
        jd, td = JaxDist(table=tab), DistTranslation(table=tab)
        np.testing.assert_array_equal(td.table.numpy(), np.asarray(jd.table))
        z = np.concatenate([rng.normal(0, 1.5, 64), [-6.0, 0.0, 6.0]]
                           ).astype(np.float32)
        vals = np.concatenate([rng.uniform(-5, 260, 64),
                               np.asarray(jd.table)[::37, 1]]
                              ).astype(np.float32)
        for dim in range(3):
            # the same table entry: exact
            np.testing.assert_array_equal(
                td.gaussian_to_val(dim, z).numpy(),
                np.asarray(jd.gaussian_to_val(dim, z)))
            np.testing.assert_allclose(
                td.val_to_gaussian(dim, vals).numpy(),
                np.asarray(jd.val_to_gaussian(dim, vals)), atol=1e-4)
        # scalars, as the sliders call it
        assert float(td.gaussian_to_val(2, 0.3)) == float(
            jd.gaussian_to_val(2, 0.3))


def test_dist_translation_reads_shipped_table():
    path = JaxBackend._repo_path('model_trained/hsv_stat_dict_ordered.pkl')
    jd, td = JaxDist(table_path=path), DistTranslation(table_path=path)
    assert td.n == jd.n == 200
    np.testing.assert_array_equal(td.table.numpy(), np.asarray(jd.table))


@pytest.mark.parametrize('draw_type', [0, 1, 2])
def test_mask_to_rgb_matches_jax(draw_type):
    rng = np.random.default_rng(draw_type)
    label = rng.integers(0, 19, (1, 32, 32)).astype(np.int32)
    label[0, :4] = 255
    np.testing.assert_array_equal(mask_to_rgb(label, draw_type),
                                  jax_mask_to_rgb(label, draw_type))


def test_load_directions_matches_jax(tmp_path):
    for rel, dim, n in (('model_trained/shape_dir_used', 16, 4),
                        ('model_trained/texture_dir_used', 8, 2)):
        got, ref = t_dirs.load_directions(rel), j_dirs.load_directions(rel)
        assert len(got) == len(ref) == n
        for g, r in zip(got, ref):
            assert g.dtype == np.float32 and g.shape == (dim,)
            np.testing.assert_array_equal(g, r)
    assert t_dirs.load_directions(str(tmp_path / 'absent')) is None
    assert t_dirs.load_directions(str(tmp_path)) is None      # no pickle
    for i in (1, 0):
        with open(tmp_path / f'{i:03d}.pkl', 'wb') as f:
            pickle.dump(np.full(3, float(i)), f)
    got = t_dirs.load_directions(str(tmp_path))
    np.testing.assert_array_equal(np.stack(got), [[0, 0, 0], [1, 1, 1]])


# ------------------------------------------- Backend(), net and crop
def test_backend_needs_an_editor():
    """Backend() with no editor builds its own, on the first CUDA device by
    default (so it raises without one), and boots from model_trained/: every
    family checkpoint shipped there, loaded exactly."""
    from ctrlhair_tpu_torch import config as cfg_mod
    from ctrlhair_tpu_torch.utils.checkpoint import load_checkpoint
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA'):
            Backend()
    # the published widths of the shipped families; SEAN and the shape VAE
    # (not shipped) small
    cfg = cfg_mod.PipelineConfig(
        sean=cfg_mod.SEANConfig(crop_size=64, ngf=4, zencoder_ngf=4),
        shape=cfg_mod.ShapeConfig(img_size=64, layer_num=5, max_channel=64,
                                  hidden_in_channel=8),
        edit_size=64, compute_dtype='float32')
    be = Backend(cfg=cfg, device='cpu')
    assert be.editor.device == torch.device('cpu')
    assert be.loaded_families == {'bisenet': 5000, 'ct_gen': 50000,
                                  'ct_dis': 50000, 'rgb_pred': 2000,
                                  'curliness_pred': 2000}
    tree, _ = load_checkpoint(JaxBackend._repo_path(
        'model_trained/bisenet/checkpoints'))
    want = from_flax({'bisenet': tree})
    got = be.editor.state_dict()
    assert all(torch.equal(got[k], v) for k, v in want.items())
    assert float(be.editor.style_fallback.abs().sum()) > 0
    assert be.dist_translation.n == 200


def test_native_build_failure_raises(monkeypatch, tmp_path):
    """A native library that cannot be built raises; nothing returns None
    and no caller takes another route."""
    bad = tmp_path / 'bad.cpp'
    bad.write_text('this is not C++\n')
    broken = HostLibrary('broken_native', [bad], lambda lib: None)
    with pytest.raises(RuntimeError, match='failed for broken_native'):
        broken.lib()
    monkeypatch.setattr(port_native, 'NATIVE', broken)
    verts = np.array([[0, 0], [10, 0], [0, 10], [10, 10], [5, 5]], float)
    tris = np.array([[0, 1, 4], [1, 3, 4], [3, 2, 4], [2, 0, 4]], np.int32)
    with pytest.raises(RuntimeError, match='failed for broken_native'):
        port_native.arap_solve(verts, tris, np.arange(4), verts[:4])


# ------------------------------------------------------------ the session
@pytest.fixture(scope='module')
def port(tiny_editor):
    ed = HairEditor(port_config(tiny_editor.cfg), device='cpu')
    ed.load_state_dict(from_flax(jax.device_get(tiny_editor.params)))
    return ed


def run_session(be, make_latent, imgs, parses, hair_mask):
    """The scripted session; returns what it saw, in order."""
    img_in, img_tg = imgs
    rec = {}
    rec['input_img'], rec['input_vis'] = be.set_input_img(img_in)
    rec['target_img'], rec['target_vis'] = be.set_target_img(img_tg)
    rec['input_mask'], rec['target_mask'] = be.input_mask, be.target_mask
    rec['mask0'] = be.cur_mask
    rec['latent0'], rec['target_latent0'] = be.cur_latent, be.target_latent
    rec['out0'] = be.output()                        # current latent
    rec['be2fe0'] = (be.get_curliness_be2fe(), *be.get_color_be2fe(),
                     *be.get_shape_be2fe(), *be.get_texture_be2fe())
    be.change_curliness(0.7)
    for idx, val in enumerate((0.4, -0.8, 1.1, 0.5)):
        be.change_color(val, idx)
    for idx, val in enumerate((0.6, -0.4, 0.3, -0.2)):
        be.change_shape(val, idx)
    for idx, val in enumerate((0.9, -0.5)):
        be.change_texture(val, idx)
    be.continue_change_with_direction(
        'texture', np.eye(8, dtype=np.float32)[2], 0.25)
    rec['latent_edit'] = be.cur_latent
    rec['be2fe_edit'] = (be.get_curliness_be2fe(), *be.get_color_be2fe(),
                         *be.get_shape_be2fe(), *be.get_texture_be2fe())
    rec['mask_edit'] = be.cur_mask
    rec['out_edit'] = be.output()
    be.transfer_latent_representation('color')
    be.transfer_latent_representation('texture')
    rec['latent_ct'] = be.cur_latent
    rec['out_ct'] = be.output(be.cur_latent)         # output_refresh branch
    # shape transfer, on painted parses (random weights parse no face)
    be._parse512['input'], be._parse512['target'] = parses(be)
    be._lm81['input'] = be._lm81['target'] = None
    be._parse512_np.clear()
    be.transfer_latent_representation('shape')
    rec['lm_input'], rec['lm_target'] = be._lm81['input'], be._lm81['target']
    rec['warp_target'] = be.warp_target
    rec['latent_shape'] = be.cur_latent
    rec['mask_shape'], rec['mask_shape_vis'] = be.cur_mask, be.get_cur_mask()
    rec['out_shape'] = be.output()
    lm_cached = be._lm81['target']
    be.transfer_latent_representation('shape', refresh=False)   # cached lm
    rec['lm_reused'] = be._lm81['target'] is lm_cached
    rec['warp_target2'] = be.warp_target
    # a given feature; then no blending
    rec['out_feature'] = be.output(be.cur_latent, be.target_hair_feature)
    be.blending = False
    rec['out_noblend'] = be.output()
    rec['sweep_noblend'] = be.interpolation_sweep(
        be.cur_latent, be.target_latent, np.linspace(0, 1, 2))
    be.blending = True
    rec['sweep'] = be.interpolation_sweep(
        rec['latent0'], be.cur_latent, np.linspace(0, 1, 3, dtype=np.float32))
    rec['interp'] = be.interpolate(rec['latent0'], be.cur_latent, 0.3)
    rec['interp_att'] = be.interpolate_each_att(
        rec['latent0'], be.target_latent, 0.6, 'color')
    rec['interp3'] = be.interpolate_triple(
        rec['latent0'], rec['latent_edit'], be.target_latent, 0.5, 0.3, 0.2)
    be.get_random_texture()
    be.get_random_shape()
    be.get_random_curliness()
    rec['latent_random'] = be.cur_latent
    rec['mask_random'] = be.refresh_cur_mask()[0]
    rec['batch'] = be.output_batch(make_latent(
        [rec['latent0'], rec['latent_edit'], be.cur_latent]))
    rec['texture_sweep'] = be.random_texture_sweep(2)
    be.directly_change_hair_mask(hair_mask)
    rec['mask_painted'] = be.cur_mask
    rec['hair_region'] = be.show_hair_region(be.cur_mask)
    rec['out_painted'] = be.output()
    return rec


def sample_photos():
    """samples/input.png (a 256 px portrait) and its mirror image."""
    img = read_rgb(JaxBackend._repo_path('samples/input.png'))
    return img, np.ascontiguousarray(img[:, ::-1])


@pytest.fixture(scope='module')
def sessions(tiny_editor, port):
    from ctrlhair_tpu.pipeline.latent import stack_latents as j_stack
    from ctrlhair_tpu_torch.pipeline.latent import stack_latents as t_stack
    cfg = tiny_editor.cfg
    p = cfg.bisenet.input_size
    imgs = sample_photos()
    table = np.random.default_rng(22).uniform(0, 255, (300, 3)).astype(
        np.float32)
    lab_in, _ = synthetic_face(p)
    lab_tg, _ = synthetic_face(p, cx=0.46, cy=0.57, fw=0.22, fh=0.30)
    hair_mask = np.zeros((cfg.edit_size, cfg.edit_size), np.int32)
    hair_mask[6:30, 14:50] = HAIR_IDX
    jb = JaxBackend(blending=True, cfg=cfg, editor=tiny_editor, seed=SEED,
                    hsv_table=table)
    tb = Backend(blending=True, cfg=port.cfg, editor=port, seed=SEED,
                 hsv_table=table)
    got = run_session(
        tb, t_stack, imgs,
        lambda be: (torch.tensor(lab_in), torch.tensor(lab_tg)), hair_mask)
    # The two warps agree on >= 99.9% of labels, not on all (float32 and
    # double rasterisers part at triangle edges), and the shape encoder
    # magnifies a pixel or two.  The JAX session therefore encodes the
    # port's composite, so that every stage after the warp is compared on
    # the same input; its own composite is kept and compared with the
    # port's.
    from ctrlhair_tpu.ops import warp as jax_warp
    composites = iter([got['warp_target'], got['warp_target2']])
    own = []
    real_warp = jax_warp.warp_hair_mask_between_images

    def port_composite(*args, **kwargs):
        own.append(np.asarray(real_warp(*args, **kwargs)))
        return jnp.asarray(as_np(next(composites)))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_warp, 'warp_hair_mask_between_images',
                   port_composite)
        ref = run_session(
            jb, j_stack, imgs,
            lambda be: (jnp.asarray(lab_in), jnp.asarray(lab_tg)), hair_mask)
    ref['warp_target'], ref['warp_target2'] = own
    return got, ref, tb


def test_session_analysis(sessions):
    got, ref, tb = sessions
    for k in ('input_img', 'target_img'):
        images_agree(got[k], ref[k], k)
    for k in ('input_mask', 'target_mask', 'mask0'):
        labels_agree(got[k], ref[k], k)
    latents_close(got['latent0'], ref['latent0'], 'latent0')
    latents_close(got['target_latent0'], ref['target_latent0'], 'target')
    images_agree(got['out0'], ref['out0'], 'out0')
    assert isinstance(got['latent0'], Latent)
    assert tb.input_sean_code.device == tb.device


def test_session_sliders(sessions):
    got, ref, _ = sessions
    latents_close(got['latent_edit'], ref['latent_edit'], 'latent_edit')
    for k in ('be2fe0', 'be2fe_edit'):
        g, r = np.asarray(got[k]), np.asarray(ref[k])
        # colour read-backs go through the table's mid-rank of an hsv that
        # may differ by one step
        np.testing.assert_allclose(g[[0, 4, 5, 6, 7, 8, 9, 10]],
                                   r[[0, 4, 5, 6, 7, 8, 9, 10]],
                                   atol=1e-4 * max(1.0, np.abs(r).max()))
        np.testing.assert_allclose(g[1:4], r[1:4], atol=0.05)
    # the sliders' own values come back: curliness and colour variance
    np.testing.assert_allclose(
        np.asarray(got['be2fe_edit'])[[0, 4]], [0.7, 0.5], atol=1e-4)
    labels_agree(got['mask_edit'], ref['mask_edit'], 'mask_edit')
    images_agree(got['out_edit'], ref['out_edit'], 'out_edit')


def test_session_colour_texture_transfer(sessions):
    got, ref, _ = sessions
    latents_close(got['latent_ct'], ref['latent_ct'], 'latent_ct')
    for f in ('hsv', 'pca_std', 'texture', 'curliness'):
        np.testing.assert_array_equal(
            as_np(getattr(got['latent_ct'], f)),
            as_np(getattr(got['target_latent0'], f)))
    images_agree(got['out_ct'], ref['out_ct'], 'out_ct')


def test_session_shape_transfer(sessions):
    got, ref, tb = sessions
    for k in ('lm_input', 'lm_target'):
        np.testing.assert_allclose(got[k], ref[k], atol=1e-6)
    # the landmarks are the shipped net's on the photos (it accepts both)
    for k, img in (('lm_input', tb.input_img), ('lm_target', tb.target_img)):
        net = port_landmarks.net_landmarks_81(img, device='cpu')
        assert net is not None and net[1] >= 0.9, k
        np.testing.assert_array_equal(got[k], net[0])
    assert got['lm_reused'] and ref['lm_reused']
    for k in ('warp_target', 'warp_target2'):
        labels_agree(got[k], ref[k], k)
    wt = as_np(got['warp_target'])
    s = tb.cfg.edit_size
    assert wt.shape == (s, s) and (wt == HAIR_IDX).sum() > 50
    np.testing.assert_array_equal(wt, as_np(got['warp_target2']))
    latents_close(got['latent_shape'], ref['latent_shape'], 'latent_shape')
    labels_agree(got['mask_shape'], ref['mask_shape'], 'mask_shape')
    labels_agree(got['mask_shape_vis'], ref['mask_shape_vis'], 'vis')
    images_agree(got['out_shape'], ref['out_shape'], 'out_shape')
    # on a CPU editor the warp took the plain route: no kernel launch
    from ctrlhair_tpu_torch.ops.raster_pallas import RASTER_UV
    assert RASTER_UV.launches == 0


def test_session_output_branches_and_sweeps(sessions):
    got, ref, _ = sessions
    for k in ('out_feature', 'out_noblend', 'sweep_noblend', 'sweep',
              'batch', 'texture_sweep'):
        images_agree(got[k], ref[k], k)
    assert got['sweep'].shape[0] == 3 and got['batch'].shape[0] == 3
    for k in ('interp', 'interp_att', 'interp3', 'latent_random'):
        latents_close(got[k], ref[k], k)
    labels_agree(got['mask_random'], ref['mask_random'], 'mask_random')


def test_session_painted_mask(sessions):
    got, ref, _ = sessions
    labels_agree(got['mask_painted'], ref['mask_painted'], 'mask_painted')
    labels_agree(got['hair_region'], ref['hair_region'], 'hair_region')
    images_agree(got['out_painted'], ref['out_painted'], 'out_painted')
    assert (as_np(got['mask_painted']) == HAIR_IDX).sum() > 0


def test_cur_mask_is_lazy(sessions):
    """A refresh leaves the mask on the device; reading it makes the host
    copy once."""
    _, _, tb = sessions
    tb._refresh_mask_async()
    assert tb._cur_mask_np is None and tb._cur_mask_dev is not None
    first = tb.cur_mask
    assert isinstance(first, np.ndarray) and tb.cur_mask is first
    tb.cur_mask = first.copy()
    assert tb._cur_mask_dev is None
    assert tb._cur_mask_batched().shape == (1,) + first.shape


def test_direction_padding_rule(port, tmp_path):
    """Curated pickles first, defaults up to the slider count, a near-zero
    pickle replaced by its default."""
    from ctrlhair_tpu_torch.pipeline.latent import semantic_directions
    (tmp_path / 'shape_dir_used').mkdir()
    vecs = [np.eye(16, dtype=np.float32)[3], np.zeros(16, np.float32)]
    for i, v in enumerate(vecs):
        with open(tmp_path / 'shape_dir_used' / f'{i:03d}.pkl', 'wb') as f:
            pickle.dump(v, f)
    be = Backend(editor=port, cfg=port.cfg, trained_root=str(tmp_path))
    defaults = semantic_directions(16, 4)
    assert len(be.shape_dirs) == 4 and len(be.texture_dirs) == 2
    np.testing.assert_array_equal(be.shape_dirs[0], vecs[0])
    np.testing.assert_array_equal(be.shape_dirs[1], defaults[1])
    np.testing.assert_array_equal(be.shape_dirs[2], defaults[0])
    np.testing.assert_array_equal(np.stack(be.texture_dirs),
                                  semantic_directions(8, 2))
