# Color & texture branch dataset.
#
# Port of ctrlhair_tpu/data/color_texture_dataset.py (numpy batches; the
# trainers move them to their device).  The pickles are the data root's own
# files, as the JAX package reads them.
#
# Parity target: color_texture_branch/dataset.py:20-144 — pickle-dict driven
# sampling (sean codes, rgb stats, colour-variance stats), seed-7 split via
# the catalogue, manually-labelled curliness lists, random-choice batches
# with fresh prior noise.  TPU-natively all per-item stats live in dense
# host arrays; a batch is one gather + one device_put.

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np

from ctrlhair_tpu_torch.config import ColorTextureConfig
from ctrlhair_tpu_torch.constants import HAIR_IDX
from ctrlhair_tpu_torch.data.catalog import DataCatalog


def _load_pickle(path: str):
    with open(path, 'rb') as f:
        return pickle.load(f)


class ColorTextureDataset:
    """Batch sampler over hair SEAN codes + colour statistics.

    Required files under data_root (ref: dataset.py:38-43):
      sean_code_dict.pkl      key -> [19, style_dim] codes
      rgb_stat_dict.pkl       key -> [3] mean hair RGB
      color_var_stat_dict.pkl key -> {'pca_std': float, ...}
      manual_label/curliness/{-1,1,test_-1,test_1}.txt
    """

    def __init__(self, cfg: ColorTextureConfig, data_root: str,
                 catalog: Optional[DataCatalog] = None,
                 datasets: Sequence[str] = ('ffhq', 'CelebaMask_HQ'),
                 seed: int = 7):
        self.cfg = cfg
        self.rng = np.random.default_rng(seed)
        sean_codes = _load_pickle(os.path.join(data_root,
                                               'sean_code_dict.pkl'))
        rgb_stats = _load_pickle(os.path.join(data_root,
                                              'rgb_stat_dict.pkl'))
        var_stats = _load_pickle(os.path.join(data_root,
                                              'color_var_stat_dict.pkl'))
        if catalog is None:
            catalog = DataCatalog(data_root, datasets,
                                  validity_check=False)
        keys = [k for k in catalog.items if k in sean_codes
                and k in rgb_stats and k in var_stats]
        train_set = set(catalog.train_items)
        self.train_keys = [k for k in keys if k in train_set]
        self.test_keys = [k for k in keys if k not in train_set]

        def stack(ks: List[str]):
            codes = np.stack([np.asarray(sean_codes[k], np.float32)
                              for k in ks])
            if codes.ndim == 3:        # [N,19,D] -> hair row
                codes = codes[:, HAIR_IDX]
            rgb = np.stack([np.asarray(rgb_stats[k], np.float32)[:3]
                            for k in ks])
            pca = np.asarray(
                [float(var_stats[k]['pca_std']
                       if isinstance(var_stats[k], dict) else var_stats[k])
                 for k in ks], np.float32)[:, None]
            return codes, rgb, pca

        self.train = stack(self.train_keys) if self.train_keys else None
        self.test = stack(self.test_keys) if self.test_keys else None

        # curliness manual labels (ref: dataset.py:82-87)
        self.curliness: Dict[int, np.ndarray] = {}
        cur_dir = os.path.join(data_root, 'manual_label', 'curliness')
        for label in (-1, 1):
            path = os.path.join(cur_dir, f'{label}.txt')
            if os.path.exists(path):
                with open(path) as f:
                    names = [l.strip() for l in f if l.strip()]
                idx = [self.train_keys.index(n) for n in names
                       if n in self.train_keys]
                self.curliness[label] = np.asarray(idx, np.int64)

    def _noise(self, n: int):
        cfg = self.cfg
        label = np.where(self.rng.random((n, 1)) < 0.5, 1.0, -1.0)
        return {
            'noise': self.rng.standard_normal(
                (n, cfg.noise_dim)).astype(np.float32),
            'noise_curliness': (np.abs(self.rng.standard_normal((n, 1)))
                                * label).astype(np.float32),
            'curliness_label': label.astype(np.float32),
        }

    def training_batch(self, batch_size: int) -> Dict[str, np.ndarray]:
        """Random-choice batch + fresh prior noise (ref: dataset.py:112-120)."""
        codes, rgb, pca = self.train
        idx = self.rng.integers(0, len(codes), batch_size)
        batch = {'code': codes[idx], 'rgb_mean': rgb[idx], 'pca_std': pca[idx],
                 'items': [self.train_keys[i] for i in idx]}
        batch.update(self._noise(batch_size))
        return batch

    def curliness_batch(self, batch_size: int) -> Optional[Dict[str, np.ndarray]]:
        """Labelled curliness batch for the classifier head / predictor."""
        if set(self.curliness) != {-1, 1}:
            # require BOTH class lists: a single-class batch would silently
            # train a degenerate always-one-label classifier
            return None
        half = batch_size // 2
        codes = self.train[0]
        parts, labels = [], []
        for label, idx_pool in self.curliness.items():
            if len(idx_pool) == 0:
                return None
            take = self.rng.choice(idx_pool, half)
            parts.append(codes[take])
            labels.append(np.full((half, 1), label, np.float32))
        return {'code': np.concatenate(parts),
                'curliness_label': np.concatenate(labels)}

    def test_batch(self, batch_size: int) -> Optional[Dict[str, np.ndarray]]:
        if self.test is None:
            return None
        codes, rgb, pca = self.test
        idx = self.rng.integers(0, len(codes), batch_size)
        batch = {'code': codes[idx], 'rgb_mean': rgb[idx],
                 'pca_std': pca[idx]}
        batch.update(self._noise(batch_size))
        return batch
