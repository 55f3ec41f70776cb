# The port's data layer (ctrlhair_tpu_torch/data/catalog.py,
# color_texture_dataset.py) against the JAX package's on one synthetic data
# root written here: two datasets with palette-PNG label maps (read by the
# port's own codec, by PIL on the JAX side), an angle and a gender table,
# the three pickles and the curliness lists.  Bar: the same items, split,
# keys and arrays, and the same batches from the same seed, exactly.
import os
import pickle

import numpy as np
import pytest
from PIL import Image

from ctrlhair_tpu.config import ColorTextureConfig as JaxCTConfig
from ctrlhair_tpu.data import catalog as jcat
from ctrlhair_tpu.data.color_texture_dataset import (
    ColorTextureDataset as JaxDataset)
from ctrlhair_tpu_torch.config import ColorTextureConfig
from ctrlhair_tpu_torch.constants import HAIR_IDX, HAT_IDX
from ctrlhair_tpu_torch.data import catalog
from ctrlhair_tpu_torch.data.color_texture_dataset import ColorTextureDataset

STYLE = 16


def label_map(rng, hair: float, hat: float) -> np.ndarray:
    lab = rng.integers(0, 13, (32, 32)).astype(np.uint8)
    flat = lab.reshape(-1)
    idx = rng.permutation(flat.size)
    n_hair, n_hat = int(hair * flat.size), int(hat * flat.size)
    flat[idx[:n_hair]] = HAIR_IDX
    flat[idx[n_hair:n_hair + n_hat]] = HAT_IDX
    return lab


@pytest.fixture(scope='module')
def root(tmp_path_factory):
    """Two datasets of 30 items; about a third fail the hair/hat, pose or
    gender filters; labels are palette PNGs (and one grey+alpha)."""
    root = tmp_path_factory.mktemp('data_root')
    rng = np.random.default_rng(0)
    pal = rng.integers(0, 256, (19, 3), dtype=np.uint8)
    codes, rgb, var = {}, {}, {}
    names_by_ds = {}
    for ds in ('ffhq', 'CelebaMask_HQ'):
        os.makedirs(root / ds / 'images_256')
        os.makedirs(root / ds / 'label')
        names = [f'{i:05d}' for i in range(30)]
        names_by_ds[ds] = names
        with open(root / ds / 'angle.csv', 'w') as f:
            f.write('name,yaw\n')
            for i, n in enumerate(names):
                f.write(f'{n}.png,{(7.5 if i % 9 == 4 else 1.5 * (i % 3))}\n')
        with open(root / ds / 'attr_gender.csv', 'w') as f:
            for i, n in enumerate(names):         # no header here
                f.write(f'{n},{1 if i % 11 == 6 else 0}\n')
        for i, n in enumerate(names):
            Image.fromarray(rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)
                            ).save(root / ds / 'images_256' / f'{n}.png')
            hair = 0.02 if i % 7 == 3 else 0.2
            hat = 0.05 if i % 13 == 5 else 0.0
            lab = label_map(rng, hair, hat)
            if i == 2:
                Image.fromarray(np.stack([lab, lab * 0 + 255], -1),
                                'LA').save(root / ds / 'label' / f'{n}.png')
            else:
                img = Image.fromarray(lab, 'P')
                img.putpalette(pal.reshape(-1).tolist())
                img.save(root / ds / 'label' / f'{n}.png')
            key = f'{ds}___{n}'
            if i % 10 != 9:                      # some items lack stats
                codes[key] = rng.standard_normal((19, STYLE)).astype(
                    np.float32)
                rgb[key] = rng.uniform(0, 255, 3).astype(np.float32)
                var[key] = ({'pca_std': float(rng.uniform(20, 80))}
                            if i % 2 else float(rng.uniform(20, 80)))
    for name, d in (('sean_code_dict', codes), ('rgb_stat_dict', rgb),
                    ('color_var_stat_dict', var)):
        with open(root / f'{name}.pkl', 'wb') as f:
            pickle.dump(d, f)
    os.makedirs(root / 'manual_label' / 'curliness')
    keys = sorted(codes)
    for label, sl in ((-1, keys[::5]), (1, keys[2::7])):
        with open(root / 'manual_label' / 'curliness' / f'{label}.txt',
                  'w') as f:
            f.write('\n'.join(sl) + '\n')
    return str(root)


def test_hair_area_valid():
    rng = np.random.default_rng(1)
    for hair, hat in ((0.2, 0.0), (0.05, 0.0), (0.2, 0.05), (0.07, 0.03)):
        lab = label_map(rng, hair, hat)
        assert catalog.hair_area_valid(lab) == jcat.hair_area_valid(lab)


@pytest.mark.parametrize('filters', [True, False])
@pytest.mark.parametrize('validity', [True, False])
def test_catalog(root, filters, validity):
    args = (root, ['ffhq', 'CelebaMask_HQ', 'absent'], filters, validity)
    got, ref = catalog.DataCatalog(*args), jcat.DataCatalog(*args)
    assert got.items == ref.items and len(got.items) > 10
    assert got.train_items == ref.train_items
    assert got.test_items == ref.test_items
    key = got.items[0]
    assert got.image_path(key) == ref.image_path(key)
    assert got.label_path(key) == ref.label_path(key)
    if filters and validity:
        assert len(got.items) < 60            # the filters removed some


def test_color_texture_dataset_batches(root):
    got = ColorTextureDataset(ColorTextureConfig(style_dim=STYLE), root)
    ref = JaxDataset(JaxCTConfig(style_dim=STYLE), root)
    assert got.train_keys == ref.train_keys and got.test_keys == ref.test_keys
    for a, b in zip(got.train + got.test, ref.train + ref.test):
        np.testing.assert_array_equal(a, b)
    assert got.curliness.keys() == ref.curliness.keys()
    for k in ref.curliness:
        np.testing.assert_array_equal(got.curliness[k], ref.curliness[k])
    for _ in range(2):
        for method in ('training_batch', 'curliness_batch', 'test_batch'):
            gb, rb = getattr(got, method)(12), getattr(ref, method)(12)
            assert gb.keys() == rb.keys(), method
            for k in rb:
                if k == 'items':
                    assert gb[k] == rb[k]
                else:
                    np.testing.assert_array_equal(gb[k], rb[k],
                                                  err_msg=f'{method}/{k}')
