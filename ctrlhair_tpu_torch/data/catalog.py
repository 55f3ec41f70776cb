# Dataset cataloguing and filtering.
#
# Port of ctrlhair_tpu/data/catalog.py; label maps are read by the port's
# own codec (utils/image.read_png: palette PNGs give their indices, as
# np.asarray(PIL.Image.open(...)) does on the JAX side).
#
# Parity target: common_dataset.py DataFilter (ref :20-103): per-dataset
# item lists from images_256/, pose filter from angle.csv (<5 deg), gender
# filter from attr_gender.csv, deterministic seed-7 shuffle with a 9.6% test
# split, and hair/hat area validity from the label maps (hair >= 7%,
# hat <= 3%).  The split seed is part of the data contract — the reference
# explicitly forbids changing it (dataset.py:36) — so it is frozen here too.

from __future__ import annotations

import os
import random
from typing import Dict, List, Optional, Sequence

import numpy as np

from ctrlhair_tpu_torch.constants import HAIR_IDX, HAT_IDX
from ctrlhair_tpu_torch.utils.image import read_png

SPLIT_SEED = 7
TEST_FRACTION = 0.096
ANGLE_LIMIT_DEG = 5.0
MIN_HAIR_AREA = 0.07
MAX_HAT_AREA = 0.03


def hair_area_valid(label_map: np.ndarray) -> bool:
    """Hair >=7% and hat <=3% of pixels (ref: common_dataset.py:84-103)."""
    n = label_map.size
    hair = (label_map == HAIR_IDX).sum() / n
    hat = (label_map == HAT_IDX).sum() / n
    return hair >= MIN_HAIR_AREA and hat <= MAX_HAT_AREA


class DataCatalog:
    """Item catalogue over one or more datasets under a data root.

    Layout contract (ref README: dataset_info_ctrlhair/):
      <root>/<dataset>/images_256/<name>.png
      <root>/<dataset>/label/<name>.png
      <root>/<dataset>/angle.csv          (name,yaw columns)
      <root>/<dataset>/attr_gender.csv    (name,gender columns)
    Item keys are '<dataset>___<name>'.
    """

    def __init__(self, data_root: str, datasets: Sequence[str],
                 filter_female_and_frontal: bool = True,
                 validity_check: bool = True):
        self.data_root = data_root
        self.datasets = list(datasets)
        items: List[str] = []
        for ds in self.datasets:
            img_dir = os.path.join(data_root, ds, 'images_256')
            if not os.path.isdir(img_dir):
                continue
            names = sorted(os.path.splitext(f)[0]
                           for f in os.listdir(img_dir)
                           if f.endswith('.png'))
            angles = self._read_csv(os.path.join(data_root, ds, 'angle.csv'))
            genders = self._read_csv(
                os.path.join(data_root, ds, 'attr_gender.csv'))
            for name in names:
                if filter_female_and_frontal:
                    if angles and abs(float(
                            angles.get(name, 0.0))) >= ANGLE_LIMIT_DEG:
                        continue
                    if genders and int(float(
                            genders.get(name, 0))) != 0:  # 0 == female
                        continue
                key = f'{ds}___{name}'
                if validity_check:
                    label = self._load_label(ds, name)
                    if label is not None and not hair_area_valid(label):
                        continue
                items.append(key)
        self.items = items
        self.train_items, self.test_items = self._split(items)

    @staticmethod
    def _read_csv(path: str) -> Optional[Dict[str, str]]:
        if not os.path.exists(path):
            return None
        out = {}
        with open(path) as f:
            lines = [l.strip() for l in f if l.strip()]
        if not lines:
            return out
        def _numeric(s: str) -> bool:
            try:
                float(s)
                return True
            except ValueError:
                return False
        first = lines[0].split(',')
        start = 1 if len(first) >= 2 and not _numeric(first[1]) else 0
        for line in lines[start:]:
            parts = line.split(',')
            if len(parts) >= 2:
                out[os.path.splitext(parts[0])[0]] = parts[1]
        return out

    def _load_label(self, ds: str, name: str) -> Optional[np.ndarray]:
        path = os.path.join(self.data_root, ds, 'label', name + '.png')
        if not os.path.exists(path):
            return None
        return read_png(path)

    @staticmethod
    def _split(items: List[str]):
        """Deterministic seed-7 shuffle + 9.6% test split
        (ref: common_dataset.py:33-34,63-65)."""
        order = list(items)
        random.Random(SPLIT_SEED).shuffle(order)
        n_test = int(len(order) * TEST_FRACTION)
        return order[n_test:], order[:n_test]

    def image_path(self, key: str) -> str:
        ds, name = key.split('___', 1)
        return os.path.join(self.data_root, ds, 'images_256', name + '.png')

    def label_path(self, key: str) -> str:
        ds, name = key.split('___', 1)
        return os.path.join(self.data_root, ds, 'label', name + '.png')
