# SEAN (pix2pix) training dataset: (image, label) pairs.
#
# Port of ctrlhair_tpu/data/sean_dataset.py: paired images and label maps
# from parallel directories, sorted and matched by name, random batches with
# horizontal-flip augmentation.  The rng draws in JAX's order (the index
# vector, then one flip draw per item), so one seed gives the same batches.
# Images are read by the port's own codec (utils/image.read_rgb, equal to
# PIL's convert('RGB')); a size other than the crop is resized bilinearly,
# rounded half to even and clipped to [0,255], labels by nearest.

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from ctrlhair_tpu_torch.ops.resize import resize_bilinear_nhwc, resize_nearest
from ctrlhair_tpu_torch.utils.image import read_png, read_rgb


class SEANDataset:
    """Batches of {'image': [-1,1] NHWC float32, 'label': int32 [N,S,S]}."""

    def __init__(self, image_dir: str, label_dir: str, crop_size: int = 256,
                 flip: bool = True, seed: int = 0):
        self.image_dir = image_dir
        self.label_dir = label_dir
        self.crop_size = crop_size
        self.flip = flip
        self.rng = np.random.default_rng(seed)
        imgs = {os.path.splitext(f)[0] for f in os.listdir(image_dir)
                if f.endswith('.png')} if os.path.isdir(image_dir) else set()
        labs = {os.path.splitext(f)[0] for f in os.listdir(label_dir)
                if f.endswith('.png')} if os.path.isdir(label_dir) else set()
        self.names = sorted(imgs & labs)

    def __len__(self) -> int:
        return len(self.names)

    def _load(self, name: str):
        img = read_rgb(os.path.join(self.image_dir, name + '.png'))
        lab = read_png(os.path.join(self.label_dir, name + '.png')).astype(
            np.int32)
        s = self.crop_size
        if img.shape[:2] != (s, s):
            up = resize_bilinear_nhwc(
                torch.from_numpy(img.astype(np.float32))[None], (s, s))[0]
            img = torch.clamp(torch.round(up), 0, 255).numpy()
        if lab.shape[:2] != (s, s):
            lab = resize_nearest(torch.from_numpy(lab), (s, s)).numpy()
        return img.astype(np.float32) / 127.5 - 1.0, lab

    def batch(self, batch_size: int) -> Optional[Dict[str, np.ndarray]]:
        if not self.names:
            return None
        idx = self.rng.integers(0, len(self.names), batch_size)
        imgs, labs = [], []
        for i in idx:
            img, lab = self._load(self.names[i])
            if self.flip and self.rng.integers(2):
                img = img[:, ::-1]
                lab = lab[:, ::-1]
            imgs.append(img)
            labs.append(lab)
        return {'image': np.stack(imgs).astype(np.float32),
                'label': np.stack(labs).astype(np.int32)}
