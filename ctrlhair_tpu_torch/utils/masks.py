# Segmentation-mask utilities (one-hot encoding, hair/face split).
#
# Port of ctrlhair_tpu/utils/masks.py.  Public functions keep the channels-
# last layout ([..., H, W, C]); the models convert to NCHW inside.

from __future__ import annotations

import torch
import torch.nn.functional as F

from ctrlhair_tpu_torch.constants import HAIR_IDX, NUM_CLASSES, UNKNOWN_LABEL


def label_to_one_hot(label: torch.Tensor, num_classes: int = NUM_CLASSES,
                     dtype=torch.float32) -> torch.Tensor:
    """[..., H, W] int labels -> [..., H, W, num_classes] one-hot.

    Pixels equal to 255 (unknown) produce an all-zero row, as do any other
    out-of-range labels (the JAX twin's jax.nn.one_hot semantics).
    """
    label = label.long()
    valid = (label >= 0) & (label < num_classes)
    oh = F.one_hot(torch.where(valid, label, num_classes), num_classes + 1)
    return oh[..., :num_classes].to(dtype)


def one_hot_to_label(one_hot: torch.Tensor) -> torch.Tensor:
    """[..., H, W, C] -> [..., H, W] argmax labels; all-zero rows -> 255."""
    label = torch.argmax(one_hot, dim=-1).to(torch.int32)
    empty = torch.amax(one_hot, dim=-1) == 0
    return torch.where(empty, torch.full_like(label, UNKNOWN_LABEL), label)


def split_hair_face(one_hot: torch.Tensor):
    """Split [..., C=19] one-hot into hair [..., 1] and face [..., 18]."""
    hair = one_hot[..., HAIR_IDX:HAIR_IDX + 1]
    face = torch.cat([one_hot[..., :HAIR_IDX], one_hot[..., HAIR_IDX + 1:]],
                     dim=-1)
    return hair, face


def merge_hair_face(hair: torch.Tensor, face: torch.Tensor) -> torch.Tensor:
    """Inverse of split_hair_face: insert the hair channel at HAIR_IDX."""
    return torch.cat([face[..., :HAIR_IDX], hair, face[..., HAIR_IDX:]],
                     dim=-1)


def region_areas(one_hot: torch.Tensor) -> torch.Tensor:
    """Per-region pixel counts: [..., H, W, C] -> [..., C]."""
    return torch.sum(one_hot, dim=(-3, -2))
