# The port's data preparation (ctrlhair_tpu_torch/data/prep.py) against the
# JAX package's, on the shared tiny editor's weights (tests/conftest.py)
# and a data root made at test time from samples/input.png and its mirror
# image, with label maps painted at 256 px (a random-weight parser sees no
# hair) where the colour statistics and landmarks need hair.
#
# Bars: the HSV table, the colour-variance and median-code pickles and the
# median .npy files equal exactly (the same numpy arithmetic on equal
# inputs); the eroded-hair RGB means exactly; a label PNG the port writes
# decodes, by PIL and by the port, to the indices JAX's file holds; the
# parsed label maps equal on >= 99.9% of pixels (argmax near-ties of the
# random parser); SEAN codes within 1e-4 of the largest magnitude; the
# landmark net's landmarks within 1e-4 (tests/test_torch_landmark_net.py);
# crops within one uint8 step on >= 99.9% of pixels, the JAX crop without
# cv2 (tests/test_torch_crop.py).
import os
import pickle
import sys

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from ctrlhair_tpu.data import prep as jprep
from ctrlhair_tpu.data.catalog import DataCatalog as JaxCatalog
from ctrlhair_tpu.ops import crop as jax_crop
from ctrlhair_tpu_torch.constants import HAIR_IDX
from ctrlhair_tpu_torch.convert import from_flax
from ctrlhair_tpu_torch.data import prep
from ctrlhair_tpu_torch.data.catalog import DataCatalog
from ctrlhair_tpu_torch.ops import landmarks as tl
from ctrlhair_tpu_torch.pipeline.backend import repo_path
from ctrlhair_tpu_torch.pipeline.editor import HairEditor
from ctrlhair_tpu_torch.utils.image import read_png, read_rgb, write_rgb
from test_landmarks import synthetic_face
from test_torch_convert import port_config


@pytest.fixture(scope='module')
def port(tiny_editor):
    ed = HairEditor(port_config(tiny_editor.cfg), device='cpu')
    ed.load_state_dict(from_flax(jax.device_get(tiny_editor.params)))
    return ed


@pytest.fixture(scope='module')
def root(tmp_path_factory):
    """<root>/ffhq/images_256 with the portrait and its mirror image, and
    <root>/ffhq/label with painted faces; <root>/raw with the photos."""
    base = tmp_path_factory.mktemp('prep')
    photo = read_rgb(repo_path('samples/input.png'))
    for d in ('ffhq/images_256', 'ffhq/label', 'raw'):
        os.makedirs(base / d)
    for i, (img, cx) in enumerate(((photo, 0.5), (photo[:, ::-1], 0.46))):
        write_rgb(str(base / 'ffhq/images_256' / f'{i:05d}.png'), img)
        write_rgb(str(base / 'raw' / f'{i:05d}.png'), img)
        lab = synthetic_face(256, cx=cx)[0]
        Image.fromarray(lab.astype(np.uint8), mode='L').save(
            base / 'ffhq/label' / f'{i:05d}.png')
    return str(base)


def catalogs(root):
    return (JaxCatalog(root, ['ffhq'], validity_check=False),
            DataCatalog(root, ['ffhq'], validity_check=False))


def test_compute_masks_and_label_files(tiny_editor, port, root, tmp_path):
    img_dir = os.path.join(root, 'ffhq', 'images_256')
    assert jprep.compute_masks(tiny_editor, img_dir, str(tmp_path / 'j'),
                               batch_size=2) == 2
    assert prep.compute_masks(port, img_dir, str(tmp_path / 'p'),
                              batch_size=2) == 2
    for name in ('00000.png', '00001.png'):
        ref = np.asarray(Image.open(tmp_path / 'j' / name))
        got = read_png(str(tmp_path / 'p' / name))
        assert got.shape == ref.shape == (256, 256)
        assert (got == ref).mean() >= 0.999, (got == ref).mean()
        np.testing.assert_array_equal(
            np.asarray(Image.open(tmp_path / 'p' / name)), got)
    # the same label map written by both sides decodes to the same indices
    lab = synthetic_face(256)[0]
    jprep.write_rgb_gray(str(tmp_path / 'jl.png'), lab)
    prep.write_rgb_gray(str(tmp_path / 'pl.png'), lab)
    for reader in (read_png, lambda p: np.asarray(Image.open(p))):
        np.testing.assert_array_equal(reader(str(tmp_path / 'pl.png')),
                                      reader(str(tmp_path / 'jl.png')))
        np.testing.assert_array_equal(reader(str(tmp_path / 'pl.png')), lab)


def test_sean_codes_and_median_codes(tiny_editor, port, root, tmp_path):
    jcat, pcat = catalogs(root)
    assert jcat.items == pcat.items and len(pcat.items) == 2
    ref = jprep.compute_sean_codes(tiny_editor, jcat,
                                   str(tmp_path / 'j.pkl'), batch_size=2)
    got = prep.compute_sean_codes(port, pcat, str(tmp_path / 'p.pkl'),
                                  batch_size=2)
    with open(tmp_path / 'p.pkl', 'rb') as f:
        assert set(pickle.load(f)) == set(ref)
    for k in ref:
        assert got[k].shape == (19, port.cfg.sean.style_dim)
        np.testing.assert_allclose(
            got[k], ref[k], rtol=0,
            atol=1e-4 * max(1.0, float(np.abs(ref[k]).max())))
    med_ref = jprep.compute_mean_style_codes(ref, str(tmp_path / 'jm'))
    med = prep.compute_mean_style_codes(ref, str(tmp_path / 'pm'))
    np.testing.assert_array_equal(med, med_ref)
    for cls in range(19):
        np.testing.assert_array_equal(
            np.load(tmp_path / 'pm' / 'median' / str(cls) / 'ACE.npy'),
            np.load(tmp_path / 'jm' / 'median' / str(cls) / 'ACE.npy'))
    # the editor's fallback loader reads what it wrote
    port.load_style_fallback(str(tmp_path / 'pm' / 'median'))
    np.testing.assert_array_equal(port.style_fallback.numpy(), med)


def test_colour_statistics(root, tmp_path):
    jcat, pcat = catalogs(root)
    ref = jprep.compute_color_stats(jcat, str(tmp_path / 'jr.pkl'),
                                    str(tmp_path / 'jh.pkl'))
    got = prep.compute_color_stats(pcat, str(tmp_path / 'pr.pkl'),
                                   str(tmp_path / 'ph.pkl'), device='cpu')
    if not torch.cuda.is_available():
        # the erosion runs on cuda:0 unless the caller asks for the CPU
        with pytest.raises(RuntimeError, match='no CUDA device'):
            prep.compute_color_stats(pcat, '', '')
    assert set(got) == set(ref) and len(got) == 2
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])
    for name in ('r', 'h'):
        with open(tmp_path / f'p{name}.pkl', 'rb') as f:
            a = pickle.load(f)
        with open(tmp_path / f'j{name}.pkl', 'rb') as f:
            b = pickle.load(f)
        if name == 'h':
            assert a.shape == (2, 3)
            np.testing.assert_array_equal(a, b)
    ref = jprep.compute_color_variance(jcat, str(tmp_path / 'jv.pkl'))
    got = prep.compute_color_variance(pcat, str(tmp_path / 'pv.pkl'))
    assert got == ref and len(got) == 2
    with open(tmp_path / 'pv.pkl', 'rb') as f:
        assert pickle.load(f) == ref
    assert all(v['pca_std'] > 0 for v in got.values())


def test_landmarks(tiny_editor, port, root):
    jcat, pcat = catalogs(root)
    tl.unload_landmark_net()
    ref = jprep.compute_landmarks(tiny_editor, jcat, '')
    got = prep.compute_landmarks(port, pcat, '')
    assert set(got) == set(ref) and len(got) == 2
    for k in ref:
        assert got[k].shape == (81, 2)
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-4)
    # the photos are faces: the shipped net gave them, not the contour
    assert tl._NET is not None
    tl.unload_landmark_net()


def test_crop_images(tiny_editor, port, root, tmp_path, monkeypatch):
    def crop_without_cv2(*args, crop=jax_crop.recreate_aligned_image,
                         **kwargs):
        with pytest.MonkeyPatch.context() as mp:
            mp.setitem(sys.modules, 'cv2', None)
            return crop(*args, **kwargs)
    monkeypatch.setattr(jax_crop, 'recreate_aligned_image', crop_without_cv2)
    raw = os.path.join(root, 'raw')
    (tmp_path / 'raw_plus').mkdir()
    (tmp_path / 'raw_plus' / 'broken.png').write_bytes(b'not a png')
    assert jprep.crop_images(tiny_editor, raw, str(tmp_path / 'j'), 64) == 2
    assert prep.crop_images(port, raw, str(tmp_path / 'p'), 64) == 2
    assert prep.crop_images(port, str(tmp_path / 'raw_plus'),
                            str(tmp_path / 'none'), 64) == 0
    for name in ('00000.png', '00001.png'):
        got = read_rgb(str(tmp_path / 'p' / name))
        ref = read_rgb(str(tmp_path / 'j' / name))
        assert got.shape == ref.shape == (64, 64, 3)
        d = np.abs(got.astype(np.int32) - ref)
        assert (d <= 1).mean() >= 0.999
