# The port's shape data (ctrlhair_tpu_torch/data/shape_dataset.py and
# ops/warp.warp_for_image_with_idx) against the JAX package's, on one data
# root written here: two datasets of painted 128 px face parsings (palette
# PNGs, read by the port's own codec and by PIL on the JAX side).  Bars:
# ShapeDataset's batches equal JAX's for one seed, exactly; the warp pool
# has JAX's file names and every mask equals JAX's on >= 99.9% of labels
# (JAX's default host raster against the port's CPU route, the plain
# version of the kernel); warp_for_image_with_idx likewise.  A CUDA error
# inside a pool worker fails the call, and an unreadable label is skipped.
import os

import numpy as np
import pytest
import torch
from PIL import Image

from ctrlhair_tpu.config import ShapeConfig as JaxShapeConfig
from ctrlhair_tpu.data import shape_dataset as jsd
from ctrlhair_tpu.data.catalog import DataCatalog as JaxCatalog
from ctrlhair_tpu.ops import landmarks as jlm
from ctrlhair_tpu.ops import warp as jwarp
from ctrlhair_tpu_torch.config import ShapeConfig
from ctrlhair_tpu_torch.constants import HAIR_IDX, PARSING_LABEL_LIST
from ctrlhair_tpu_torch.data import shape_dataset as sd
from ctrlhair_tpu_torch.data.catalog import DataCatalog
from ctrlhair_tpu_torch.ops import landmarks as plm
from ctrlhair_tpu_torch.ops import warp

LABELS_EQUAL = 0.999
SIZE = 128
POOL = 2


def paint_face(cx, cy, scale, size=SIZE):
    """A CelebA-style parse: neck, hair cap, skin, brows, eyes, nose, lips
    and mouth at face-proportional places."""
    idx = {n: i for i, n in enumerate(PARSING_LABEL_LIST)}
    ys, xs = np.mgrid[0:size, 0:size] / size
    lab = np.zeros((size, size), np.uint8)
    fw, fh = 0.26 * scale, 0.34 * scale

    def ellipse(ex, ey, rx, ry, name):
        lab[((xs - ex) / rx) ** 2 + ((ys - ey) / ry) ** 2 <= 1] = idx[name]

    lab[(ys > cy) & (np.abs(xs - cx) < 0.5 * fw)] = idx['neck']
    ellipse(cx, cy - 0.06 * scale, fw * 1.25, fh * 1.15, 'hair')
    ellipse(cx, cy, fw, fh, 'skin_other')
    lab[(ys < cy - 0.24 * scale) & (lab == idx['skin_other'])] = idx['hair']
    ex, ey = 0.45 * fw, cy - 0.30 * fh
    for side, sign in (('l', -1), ('r', 1)):
        ellipse(cx + sign * ex, ey, 0.17 * fw, 0.05 * fh, f'{side}_eye')
        ellipse(cx + sign * ex, ey - 0.14 * fh, 0.22 * fw, 0.02 * fh,
                f'{side}_brow')
    ellipse(cx, cy + 0.05 * fh, 0.13 * fw, 0.22 * fh, 'nose')
    my = cy + 0.55 * fh
    ellipse(cx, my - 0.03 * fh, 0.30 * fw, 0.045 * fh, 'u_lip')
    ellipse(cx, my + 0.03 * fh, 0.30 * fw, 0.045 * fh, 'l_lip')
    ellipse(cx, my, 0.24 * fw, 0.022 * fh, 'mouth')
    return lab


@pytest.fixture(scope='module')
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp('shape_root')
    rng = np.random.default_rng(0)
    pal = rng.integers(0, 256, (19, 3), dtype=np.uint8)
    for ds in ('ffhq', 'CelebaMask_HQ'):
        os.makedirs(root / ds / 'images_256')
        os.makedirs(root / ds / 'label')
        for i in range(4):
            n = f'{i:05d}'
            Image.fromarray(rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)
                            ).save(root / ds / 'images_256' / f'{n}.png')
            img = Image.fromarray(paint_face(
                rng.uniform(0.44, 0.56), rng.uniform(0.46, 0.56),
                rng.uniform(0.8, 1.05)), 'P')
            img.putpalette(pal.reshape(-1).tolist())
            img.save(root / ds / 'label' / f'{n}.png')
    return str(root)


@pytest.fixture(scope='module')
def pools(root):
    """The JAX pool (in the data root, where ShapeDataset reads it) and the
    port's, from the same catalogue and seed."""
    datasets = ['ffhq', 'CelebaMask_HQ']
    jdir = os.path.join(root, 'shape_training_wrap_pool')
    pdir = os.path.join(root, 'port_pool')
    nj = jsd.generate_warp_pool(JaxCatalog(root, datasets,
                                           validity_check=False),
                                jdir, POOL, num_threads=2, seed=3)
    npt = sd.generate_warp_pool(DataCatalog(root, datasets,
                                            validity_check=False),
                                pdir, POOL, num_threads=2, seed=3,
                                device='cpu')
    return jdir, pdir, nj, npt


def agree(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    return float((a == b).mean())


def test_warp_pool_matches_jax(pools):
    jdir, pdir, nj, npt = pools
    assert nj == npt == POOL
    names = sorted(os.listdir(jdir))
    assert sorted(os.listdir(pdir)) == names
    for name in names:
        got = np.asarray(Image.open(os.path.join(pdir, name)))
        want = np.asarray(Image.open(os.path.join(jdir, name)))
        assert (got == HAIR_IDX).sum() > 0
        assert agree(got, want) >= LABELS_EQUAL, name


def test_pool_resumes_and_skips_unreadable_labels(root, pools, tmp_path):
    """An existing output is counted and not redone; an item whose label
    does not decode is skipped, the others are written."""
    _, pdir, _, _ = pools
    cat = DataCatalog(root, ['ffhq', 'CelebaMask_HQ'], validity_check=False)
    before = {n: os.path.getmtime(os.path.join(pdir, n))
              for n in os.listdir(pdir)}
    assert sd.generate_warp_pool(cat, pdir, POOL, num_threads=2, seed=3,
                                 device='cpu') == POOL
    assert {n: os.path.getmtime(os.path.join(pdir, n))
            for n in os.listdir(pdir)} == before
    broken = str(tmp_path / 'lab.png')
    with open(broken, 'wb') as f:
        f.write(b'not a png')
    bad_key = sorted(cat.train_items)[0]
    real = cat.label_path
    cat.label_path = lambda key: broken if key == bad_key else real(key)
    out = str(tmp_path / 'pool')
    # seed 21: two of the three pairs hold the broken label
    n = sd.generate_warp_pool(cat, out, 3, num_threads=2, seed=21,
                              device='cpu')
    rng = np.random.default_rng(21)
    items = list(cat.train_items)
    pairs = list(zip(rng.integers(0, len(items), 3),
                     rng.integers(0, len(items), 3)))
    ok = [i for i, (a, b) in enumerate(pairs)
          if bad_key not in (items[a], items[b])]
    assert n == len(ok) == len(os.listdir(out)) == 1


def test_cuda_error_in_a_worker_fails_the_call(root, tmp_path,
                                               monkeypatch):
    def failing(*args, **kwargs):
        raise torch.cuda.OutOfMemoryError('CUDA out of memory')

    monkeypatch.setattr(warp, 'hair_mask_transfer_warp', failing)
    cat = DataCatalog(root, ['ffhq', 'CelebaMask_HQ'], validity_check=False)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        sd.generate_warp_pool(cat, str(tmp_path / 'p'), 5, num_threads=3,
                              device='cpu')

    def kernel_error(*args, **kwargs):
        raise RuntimeError('raster_uv launch: CUDA error 700 (an illegal '
                           'memory access was encountered)')

    monkeypatch.setattr(warp, 'hair_mask_transfer_warp', kernel_error)
    with pytest.raises(RuntimeError, match='CUDA error 700'):
        sd.generate_warp_pool(cat, str(tmp_path / 'q'), 5, num_threads=3,
                              device='cpu')
    assert os.listdir(tmp_path / 'q') == []


def test_shape_dataset_batches_equal_jax(root, pools):
    jcfg = JaxShapeConfig(img_size=64, layer_num=5)
    want = jsd.ShapeDataset(jcfg, root, seed=11).training_batch(5)
    got = sd.ShapeDataset(ShapeConfig(img_size=64, layer_num=5), root,
                          seed=11).training_batch(5)
    assert set(got) == set(want) == {'target', 'face', 'hair', 'real'}
    for k in want:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    # at the labels' own size nothing is resized
    same = sd.ShapeDataset(ShapeConfig(img_size=SIZE), root, seed=2)
    assert same.training_batch(2)['target'].shape == (2, SIZE, SIZE, 19)
    empty = sd.ShapeDataset(ShapeConfig(), root, pool_dir='absent')
    assert empty.pool_files == [] and empty.training_batch(2) is None


def test_warp_for_image_with_idx_matches_jax(root):
    cat = DataCatalog(root, ['ffhq', 'CelebaMask_HQ'], validity_check=False)
    jcat = JaxCatalog(root, ['ffhq', 'CelebaMask_HQ'], validity_check=False)
    keys = sorted(cat.train_items)[:2]
    lms = {k: plm.contour_landmarks_81(
        np.asarray(Image.open(cat.label_path(k)))) for k in keys}
    np.testing.assert_array_equal(
        lms[keys[0]], jlm.contour_landmarks_81(
            np.asarray(Image.open(cat.label_path(keys[0])))))
    want = jwarp.warp_for_image_with_idx(jcat, lms, keys[0], keys[1])
    got = warp.warp_for_image_with_idx(cat, lms, keys[0], keys[1],
                                       device='cpu')
    assert isinstance(got, torch.Tensor) and got.dtype == torch.int32
    assert agree(got.numpy(), want) >= LABELS_EQUAL


def test_pool_and_warp_default_to_the_card(root, tmp_path, monkeypatch):
    """Without a device argument both ask for the first CUDA device, and
    raise when there is none."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    cat = DataCatalog(root, ['ffhq', 'CelebaMask_HQ'], validity_check=False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        sd.generate_warp_pool(cat, str(tmp_path / 'p'), 2)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        warp.warp_for_image_with_idx(cat, {}, *sorted(cat.train_items)[:2])
