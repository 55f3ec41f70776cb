# Host-side image I/O and normalisation helpers.
#
# Port of ctrlhair_tpu/utils/image.py, the part the session needs: PNG
# read/write and label-map colouring.  numpy only; PIL is imported where a
# file is read or written.
# (ref counterparts: util/imutil.py:13-24, util/mask_color_util.py:15-64)

from __future__ import annotations

import numpy as np

from ctrlhair_tpu_torch.constants import (
    HAIR_IDX, MASK_VIS_COLOR, UNKNOWN_LABEL)


def read_rgb(path: str) -> np.ndarray:
    from PIL import Image
    return np.asarray(Image.open(path).convert('RGB'))


def write_rgb(path: str, img: np.ndarray) -> None:
    from PIL import Image
    Image.fromarray(np.asarray(img).astype('uint8')).save(path)


def mask_to_rgb(label: np.ndarray, draw_type: int = 2) -> np.ndarray:
    """Visualise a [H,W] label map (ref: util/mask_color_util.py:15-64).

    draw_type 0: all classes; 1: {bg, face, hair}; 2: {hair, other}.
    """
    label = np.asarray(label)
    if label.ndim == 3 and label.shape[0] == 1:
        label = label[0]
    color = MASK_VIS_COLOR.copy()
    if draw_type == 2:
        keep = np.zeros(len(color), bool)
        keep[HAIR_IDX] = True
        color[~keep] = [255, 255, 255]
    elif draw_type == 1:
        keep = np.zeros(len(color), bool)
        keep[HAIR_IDX] = True
        keep[0] = True
        color[~keep] = [237, 28, 36]
    lut = np.concatenate([color, np.full((256 - len(color), 3), 255, np.uint8)])
    return lut[np.where(label == UNKNOWN_LABEL, 255, label)]
