# Offline data preparation: raw photos -> the training data root.
#
# Port of ctrlhair_tpu/data/prep.py:
#   crop_images             FFHQ-align and crop raw photos (images_256/)
#   compute_masks           the face parser's label maps (label/)
#   compute_sean_codes      per-image [19, D] style codes (sean_code_dict)
#   compute_color_stats     eroded-hair RGB means + the sorted HSV table
#   compute_color_variance  the first PCA component's std of the hair
#                           pixels (numpy SVD, as in JAX)
#   compute_mean_style_codes  per-class median codes (median/<c>/ACE.npy)
#   compute_landmarks       81 landmarks from the label map and the photo
# The device stages (parse, SEAN encode, the landmark net) run batched on
# the editor's device.  Images and label maps go through the port's own
# codec (utils/image.py): no PIL, no cv2.  A label map is written as an
# 8-bit grey PNG, which decodes to the same indices as JAX's PIL 'L' file.

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ctrlhair_tpu_torch.constants import HAIR_IDX
from ctrlhair_tpu_torch.data.catalog import DataCatalog
from ctrlhair_tpu_torch.utils.image import (
    read_png, read_rgb, write_png, write_rgb)


def _batched(items: Sequence, n: int):
    for i in range(0, len(items), n):
        yield items[i:i + n]


def crop_images(editor, in_dir: str, out_dir: str,
                output_size: int = 256) -> int:
    """Align and crop the raw photos of `in_dir` into `out_dir` as PNGs
    (ref: dataset_scripts/script_crop.py); a photo that fails is skipped,
    as the reference's loop does.  Returns the number written."""
    os.makedirs(out_dir, exist_ok=True)
    names = sorted(f for f in os.listdir(in_dir)
                   if f.lower().endswith(('.png', '.jpg', '.jpeg')))
    done = 0
    for name in names:
        try:
            img = read_rgb(os.path.join(in_dir, name))
            out = editor.crop_face(img, output_size=output_size)
        except (OSError, ValueError):
            continue
        write_rgb(os.path.join(out_dir, os.path.splitext(name)[0] + '.png'),
                  out)
        done += 1
    return done


def write_rgb_gray(path: str, label: np.ndarray) -> None:
    """A label map as an 8-bit grey PNG (PIL's mode 'L' in JAX)."""
    write_png(path, np.asarray(label).astype(np.uint8))


@torch.inference_mode()
def compute_masks(editor, image_dir: str, label_dir: str,
                  batch_size: int = 8) -> int:
    """images_256/*.png -> label/*.png through the face parser, batched,
    at 256 px (ref: dataset_scripts/script_get_mask.py:55-71)."""
    from ctrlhair_tpu_torch.ops.resize import resize_nearest

    os.makedirs(label_dir, exist_ok=True)
    names = sorted(f for f in os.listdir(image_dir) if f.endswith('.png'))
    done = 0
    for chunk in _batched(names, batch_size):
        imgs = np.stack([read_rgb(os.path.join(image_dir, f))
                         for f in chunk])
        labels = resize_nearest(editor.parse(imgs), (256, 256)).cpu().numpy()
        for f, lab in zip(chunk, labels):
            write_rgb_gray(os.path.join(label_dir, f), lab)
            done += 1
    return done


def _pairs(catalog: DataCatalog, keys):
    """(key, image path, label path) of the keys with both files."""
    for key in keys:
        ip, lp = catalog.image_path(key), catalog.label_path(key)
        if os.path.exists(ip) and os.path.exists(lp):
            yield key, ip, lp


@torch.inference_mode()
def compute_sean_codes(editor, catalog: DataCatalog, out_path: str,
                       batch_size: int = 8) -> Dict[str, np.ndarray]:
    """Per-image [19, style_dim] SEAN codes -> a pickle {key: codes}
    (ref: dataset_scripts/script_get_sean_code.py:40-62)."""
    out: Dict[str, np.ndarray] = {}
    device = editor.device
    for chunk in _batched(list(catalog.items), batch_size):
        pairs = list(_pairs(catalog, chunk))
        if not pairs:
            continue
        imgs = np.stack([read_rgb(ip) for _, ip, _ in pairs])
        labels = np.stack([read_png(lp).astype(np.int32)
                           for _, _, lp in pairs])
        img_f = torch.as_tensor(imgs, device=device).float() / 127.5 - 1.0
        codes = editor.sean.encode(img_f, torch.as_tensor(labels,
                                                          device=device))
        for (key, _, _), c in zip(pairs, codes.float().cpu().numpy()):
            out[key] = c
    if out_path:
        with open(out_path, 'wb') as f:
            pickle.dump(out, f)
    return out


def compute_color_stats(catalog: DataCatalog, out_rgb_path: str,
                        out_hsv_table_path: str, erode_ksize: int = 19,
                        device=None) -> Dict[str, np.ndarray]:
    """Mean RGB of the hair eroded by `erode_ksize` -> a pickle {key: [3]},
    and the column-sorted HSV table of those means -> another
    (ref: dataset_scripts/script_get_rgb_hsv_label.py:39-90).  The erosion
    runs on `device`: cuda:0 unless the caller passes another."""
    from ctrlhair_tpu_torch.ops.morphology import erode
    from ctrlhair_tpu_torch.pipeline.editor import resolve_device
    from ctrlhair_tpu_torch.utils.colorspace import rgb_to_hsv_u8

    device = resolve_device(device)
    rgb_out: Dict[str, np.ndarray] = {}
    hsv_rows: List[np.ndarray] = []
    for key, ip, lp in _pairs(catalog, catalog.items):
        img = read_rgb(ip)
        hair = torch.as_tensor(read_png(lp) == HAIR_IDX, device=device)
        hair = erode(hair.float(), erode_ksize).cpu().numpy()
        pix = img[hair.astype(bool)]
        if len(pix) < 16:
            continue
        mean = pix.mean(0)
        rgb_out[key] = mean.astype(np.float32)
        hsv = rgb_to_hsv_u8(torch.as_tensor(
            np.round(mean)[None].astype(np.uint8))).numpy()[0]
        hsv_rows.append(hsv.astype(np.float32))
    if out_rgb_path:
        with open(out_rgb_path, 'wb') as f:
            pickle.dump(rgb_out, f)
    if hsv_rows and out_hsv_table_path:
        table = np.sort(np.stack(hsv_rows), axis=0)
        with open(out_hsv_table_path, 'wb') as f:
            pickle.dump(table, f)
    return rgb_out


def compute_color_variance(catalog: DataCatalog, out_path: str
                           ) -> Dict[str, Dict[str, float]]:
    """Per image: 'pca_std', the std of the first principal component of
    the hair's RGB pixels (an SVD, for sklearn's PCA), and 'rgb_var'
    (ref: script_get_color_var_label.py:82-88)."""
    out: Dict[str, Dict[str, float]] = {}
    for key, ip, lp in _pairs(catalog, catalog.items):
        img = read_rgb(ip).astype(np.float64)
        pix = img[read_png(lp) == HAIR_IDX]
        if len(pix) < 16:
            continue
        centered = pix - pix.mean(0)
        s = np.linalg.svd(centered, compute_uv=False)
        out[key] = {'pca_std': float(s[0] / np.sqrt(len(pix) - 1)),
                    'rgb_var': float(centered.var(0).mean())}
    if out_path:
        with open(out_path, 'wb') as f:
            pickle.dump(out, f)
    return out


def compute_mean_style_codes(sean_codes: Dict[str, np.ndarray],
                             out_dir: Optional[str] = None) -> np.ndarray:
    """Per-class median SEAN codes over a dataset, regions absent from an
    image (all-zero codes) left out (ref: sean_codes/get_mean_code.py:
    15-43): the fallback codes of regions an input lacks.  Writes
    median/<class>/ACE.npy under `out_dir`, the layout
    HairEditor.load_style_fallback reads.  Returns [19, style_dim]."""
    stacked = np.stack(list(sean_codes.values()))       # [N, 19, D]
    medians = np.zeros(stacked.shape[1:], np.float32)
    for cls in range(stacked.shape[1]):
        rows = stacked[:, cls]
        present = rows[np.abs(rows).sum(axis=1) > 0]
        if len(present):
            medians[cls] = np.median(present, axis=0)
    if out_dir:
        for cls in range(len(medians)):
            d = os.path.join(out_dir, 'median', str(cls))
            os.makedirs(d, exist_ok=True)
            np.save(os.path.join(d, 'ACE.npy'), medians[cls])
    return medians


def compute_landmarks(editor, catalog: DataCatalog, out_path: str
                      ) -> Dict[str, np.ndarray]:
    """Per image 81 landmarks in [0,1] -> a pickle {key: [81,2]}: the
    label map at 512 px and the photo through ops.landmarks' 'auto'
    estimator on the editor's device (ref: dataset_scripts/
    script_landmark_detection.py, dlib replaced)."""
    from ctrlhair_tpu_torch.ops.landmarks import estimate_landmarks_81
    from ctrlhair_tpu_torch.ops.resize import resize_nearest

    out: Dict[str, np.ndarray] = {}
    for key in catalog.items:
        lp = catalog.label_path(key)
        if not os.path.exists(lp):
            continue
        label = torch.as_tensor(read_png(lp).astype(np.int32))
        label512 = resize_nearest(label, (512, 512)).numpy()
        ip = catalog.image_path(key)
        img = read_rgb(ip) if os.path.exists(ip) else None
        out[key] = estimate_landmarks_81(label512, image=img,
                                         device=editor.device)
    if out_path:
        with open(out_path, 'wb') as f:
            pickle.dump(out, f)
    return out
