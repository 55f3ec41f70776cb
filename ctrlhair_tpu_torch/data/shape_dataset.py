# Shape branch dataset: the pool of pre-warped masks, and its generator.
#
# Port of ctrlhair_tpu/data/shape_dataset.py.  Training batches are drawn
# from a disk pool of warped masks named
# '<hairdir>___<hair>___<facedir>___<face>___NN.png', mirrored at random;
# the 'real' adversarial batch uses CelebA masks only.  ShapeDataset draws
# from its rng in JAX's order (pool file, mirror, real mask, its mirror), so
# one seed gives JAX's batches; labels are read by the port's own codec,
# resized by nearest and one-hot encoded as there.
#
# generate_warp_pool keeps JAX's contract (the pair schedule from `seed`,
# the file names, an existing output counted and skipped so a run can
# resume, the parsing-contour landmarks of both sides, `num_threads`
# workers) with two deviations:
#   * Device.  The parsings go to the device the caller names (default the
#     first CUDA device) as tensors, so ops/warp takes the kernel route
#     there (csrc/raster_uv.cu).  JAX hands the warp numpy arrays, which in
#     the port would take the plain CPU route without a word.
#   * Errors.  JAX swallows every exception of an item.  Here a worker skips
#     only the data errors a resilient worker should skip: an unreadable or
#     missing label (OSError, ValueError from the PNG reader) and a
#     degenerate landmark fit or mesh (ValueError, scipy's QhullError).  A
#     torch or CUDA error (RuntimeError, torch.cuda.*Error) or a build error
#     of a native library stops every worker and is raised by the call: a
#     kernel that fails must not turn into a short pool.  The kernel and the
#     host library are built before the workers start.
# A file is written under a temporary name and renamed, so a resumed run
# never counts a half-written mask.

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from scipy.spatial import QhullError

from ctrlhair_tpu_torch.config import ShapeConfig
from ctrlhair_tpu_torch.data.catalog import DataCatalog
from ctrlhair_tpu_torch.ops import warp
from ctrlhair_tpu_torch.ops.resize import resize_nearest
from ctrlhair_tpu_torch.utils.image import read_png, write_png
from ctrlhair_tpu_torch.utils.masks import label_to_one_hot

WARP_SIZE = 512       # the working size of a warp
# what a pool worker skips: unreadable labels, degenerate fits and meshes
SKIPPED_ERRORS = (OSError, ValueError, QhullError)


def _load_label(path: str) -> np.ndarray:
    return read_png(path).astype(np.int32)


class ShapeDataset:
    """Triplet batches (warped target, face, donor hair) and real masks,
    as float32 one-hot numpy arrays [N,S,S,19]."""

    def __init__(self, cfg: ShapeConfig, data_root: str,
                 pool_dir: str = 'shape_training_wrap_pool',
                 catalog: Optional[DataCatalog] = None,
                 datasets: Sequence[str] = ('ffhq', 'CelebaMask_HQ'),
                 seed: int = 7):
        self.cfg = cfg
        self.data_root = data_root
        self.rng = np.random.default_rng(seed)
        self.pool_dir = os.path.join(data_root, pool_dir)
        self.pool_files: List[str] = []
        if os.path.isdir(self.pool_dir):
            self.pool_files = sorted(
                f for f in os.listdir(self.pool_dir) if f.endswith('.png'))
        if catalog is None:
            catalog = DataCatalog(data_root, datasets, validity_check=False)
        self.catalog = catalog
        # the real adversarial batch: CelebA only
        self.real_keys = [k for k in catalog.train_items
                          if k.startswith('CelebaMask_HQ')] or \
            list(catalog.train_items)

    def _resize(self, label: np.ndarray) -> np.ndarray:
        s = self.cfg.img_size
        if label.shape[0] == s:
            return label
        return resize_nearest(torch.from_numpy(label), (s, s)).numpy()

    @staticmethod
    def _one_hot(label: np.ndarray, mirror: bool) -> np.ndarray:
        if mirror:
            label = label[:, ::-1]
        return label_to_one_hot(torch.from_numpy(label.copy())).numpy()

    def training_batch(self, batch_size: int
                       ) -> Optional[Dict[str, np.ndarray]]:
        """target = a warped pool mask; face / hair = the masks of the pair
        it was warped from; real = a CelebA mask."""
        if not self.pool_files:
            return None
        targets, faces, hairs, reals = [], [], [], []
        for _ in range(batch_size):
            fname = self.pool_files[self.rng.integers(len(self.pool_files))]
            parts = os.path.splitext(fname)[0].split('___')
            hair_key = f'{parts[0]}___{parts[1]}'
            face_key = f'{parts[2]}___{parts[3]}'
            mirror = bool(self.rng.integers(2))
            target = self._resize(_load_label(
                os.path.join(self.pool_dir, fname)))
            face = self._resize(_load_label(self.catalog.label_path(face_key)))
            hair = self._resize(_load_label(self.catalog.label_path(hair_key)))
            real_key = self.real_keys[self.rng.integers(len(self.real_keys))]
            real = self._resize(_load_label(self.catalog.label_path(real_key)))
            targets.append(self._one_hot(target, mirror))
            faces.append(self._one_hot(face, mirror))
            hairs.append(self._one_hot(hair, mirror))
            reals.append(self._one_hot(real, bool(self.rng.integers(2))))
        return {'target': np.stack(targets), 'face': np.stack(faces),
                'hair': np.stack(hairs), 'real': np.stack(reals)}


def _build_libraries(device: torch.device) -> None:
    """Build and load the native libraries a warp uses before any worker
    starts, so that a build error is raised by the call itself."""
    from ctrlhair_tpu_torch import native
    native.NATIVE.lib()
    if device.type == 'cuda':
        from ctrlhair_tpu_torch.ops.raster_pallas import RASTER_UV
        RASTER_UV.lib()


def generate_warp_pool(catalog: DataCatalog, out_dir: str, count: int,
                       use_arap: bool = True, num_threads: int = 10,
                       seed: int = 0, device=None) -> int:
    """Write `count` warped masks into `out_dir`: item i warps the hair
    mask of a random (hair, face) pair of the catalogue's training items
    onto the face's geometry and writes '<hair>___<face>___NN.png' (NN =
    i, two digits at least).  The warps run on `device` (None: the first
    CUDA device) in `num_threads` threads.  Returns the number of items
    present after the call, those found already written included."""
    from ctrlhair_tpu_torch.ops.landmarks import estimate_landmarks_81
    from ctrlhair_tpu_torch.pipeline.editor import resolve_device

    device = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    items = list(catalog.train_items)
    if len(items) < 2:
        return 0
    rng = np.random.default_rng(seed)
    pairs = [(items[a], items[b]) for a, b in zip(
        rng.integers(0, len(items), count),
        rng.integers(0, len(items), count))]
    _build_libraries(device)
    written = [0]
    failed: List[BaseException] = []
    lock = threading.Lock()

    def parsing(key: str) -> torch.Tensor:
        label = torch.from_numpy(_load_label(catalog.label_path(key)))
        return resize_nearest(label, (WARP_SIZE, WARP_SIZE))

    def work(chunk):
        for i, (hair_key, face_key) in chunk:
            if failed:
                return
            name = f'{hair_key}___{face_key}___{i:02d}.png'
            path = os.path.join(out_dir, name)
            try:
                if not os.path.exists(path):
                    hair, face = parsing(hair_key), parsing(face_key)
                    # no image: 'auto' is the contour estimator on both sides
                    hl = estimate_landmarks_81(hair.numpy())
                    fl = estimate_landmarks_81(face.numpy())
                    composite = warp.hair_mask_transfer_warp(
                        hair.to(device), face.to(device), hl, fl,
                        use_arap=use_arap)
                    tmp = f'{path}.{threading.get_ident()}.tmp'
                    write_png(tmp, composite.cpu().numpy().astype(np.uint8))
                    os.replace(tmp, path)
            except SKIPPED_ERRORS:
                continue
            except BaseException as e:       # a kernel, torch or build error
                with lock:
                    failed.append(e)
                return
            with lock:
                written[0] += 1

    chunks = [[] for _ in range(num_threads)]
    for i, pair in enumerate(pairs):
        chunks[i % num_threads].append((i, pair))
    threads = [threading.Thread(target=work, args=(c,)) for c in chunks if c]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if failed:
        raise failed[0]
    return written[0]
