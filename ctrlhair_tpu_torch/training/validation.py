# Validation canvases of training: sample sheets rendered through the
# frozen SEAN generator (ref: color_texture_branch/validation_in_train.py:
# 46-293, shape_branch/validation_in_train.py:41-159).
#
# Port of ctrlhair_tpu/training/validation.py, on the port's HairEditor and
# utils/image.Canvas:
#   ct_latent_sweep_canvas   each texture-noise dim over a value grid
#   ct_random_sample_canvas  random prior textures on one face
#   shape_sweep_canvas       each shape-latent dim, as coloured masks
#   transfer_matrix_canvas   row face x column hair donor
# Where JAX takes a parameter tree (ct_gen_params, shape_params), the port
# takes the module (a trainer's generator, say); None means the editor's
# own.  Each row renders as one batch on the editor's device.

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ctrlhair_tpu_torch.constants import HAIR_IDX
from ctrlhair_tpu_torch.utils.image import Canvas, mask_to_rgb, to_uint8
from ctrlhair_tpu_torch.utils.masks import one_hot_to_label


def _tile(t: torch.Tensor, n: int) -> torch.Tensor:
    return t.repeat((n,) + (1,) * (t.dim() - 1))


def _render_hair(editor, sean_codes, label, feats) -> np.ndarray:
    """The codes [1,19,D] with the hair code of each of `feats` [n,D],
    rendered under label [1,S,S] -> [n,S,S,3] in [-1,1], on the host."""
    n = feats.shape[0]
    codes = _tile(editor._as(sean_codes, torch.float32), n).clone()
    codes[:, HAIR_IDX] = feats.to(codes.dtype)
    label = _tile(editor._as(label, torch.int32), n)
    return editor._render(codes, label).float().cpu().numpy()


def _ct_feats(editor, ct_gen, batch: Dict[str, torch.Tensor]):
    gen = editor.ct_gen if ct_gen is None else ct_gen
    return gen({k: editor._as(v, torch.float32) for k, v in batch.items()}
               )['code']


@torch.inference_mode()
def ct_latent_sweep_canvas(editor, ct_gen, sean_codes, label,
                           base_data: Dict[str, torch.Tensor],
                           out_path: Optional[str] = None,
                           values: Sequence[float] = (-2, -1, 0, 1, 2),
                           noise_dim: int = 8) -> np.ndarray:
    """Row d: the texture noise's dim d set to each of `values` in
    `base_data` (one sample), the generated hair code rendered in the face
    of `sean_codes` [1,19,D] under `label` [1,S,S]."""
    n = len(values)
    canvas = Canvas(noise_dim, n, cell=label.shape[-1])
    for d in range(noise_dim):
        batch = {k: _tile(editor._as(v, torch.float32), n)
                 for k, v in base_data.items()}
        batch['noise'] = batch['noise'].clone()
        batch['noise'][:, d] = torch.tensor(values, dtype=torch.float32,
                                            device=editor.device)
        imgs = _render_hair(editor, sean_codes, label,
                            _ct_feats(editor, ct_gen, batch))
        for c, im in enumerate(imgs):
            canvas.paste(d, c, to_uint8(im))
    if out_path:
        canvas.save(out_path)
    return canvas.img


@torch.inference_mode()
def ct_random_sample_canvas(editor, ct_gen, sean_codes, label,
                            base_data: Dict[str, torch.Tensor],
                            draws: Optional[Dict[str, torch.Tensor]] = None,
                            n: int = 8, out_path: Optional[str] = None,
                            seed: int = 0) -> np.ndarray:
    """One row of n random prior textures on the same face.  `draws`:
    {'noise': [n, noise_dim], 'noise_curliness': [n, 1]} normal draws
    (JAX draws them from a key); given none, they come from a generator
    seeded by `seed` on the host."""
    if draws is None:
        gen = torch.Generator().manual_seed(seed)
        draws = {'noise': torch.randn(
                     (n, base_data['noise'].shape[-1]), generator=gen),
                 'noise_curliness': torch.randn((n, 1), generator=gen)}
    n = draws['noise'].shape[0]
    batch = {k: _tile(editor._as(v, torch.float32), n)
             for k, v in base_data.items()}
    batch.update(draws)
    imgs = _render_hair(editor, sean_codes, label,
                        _ct_feats(editor, ct_gen, batch))
    canvas = Canvas(1, n, cell=label.shape[-1])
    for c, im in enumerate(imgs):
        canvas.paste(0, c, to_uint8(im))
    if out_path:
        canvas.save(out_path)
    return canvas.img


@torch.inference_mode()
def shape_sweep_canvas(editor, shape_gen, face_code, base_shape,
                       out_path: Optional[str] = None,
                       values: Sequence[float] = (-2, -1, 0, 1, 2),
                       dims: Optional[Sequence[int]] = None) -> np.ndarray:
    """Row r: shape-latent dim dims[r] set to each of `values` in
    `base_shape` [1, hair_dim], decoded with `face_code` [1, F] and drawn
    as a coloured mask."""
    sg = editor.shape if shape_gen is None else shape_gen
    base_shape = editor._as(base_shape, torch.float32)
    dims = list(dims) if dims is not None else list(range(
        base_shape.shape[-1]))
    n = len(values)
    canvas = Canvas(len(dims), n, cell=editor.cfg.edit_size)
    face = _tile(editor._as(face_code, torch.float32), n)
    for r, d in enumerate(dims):
        shape = _tile(base_shape, n).clone()
        shape[:, d] = torch.tensor(values, dtype=torch.float32,
                                   device=editor.device)
        labels = one_hot_to_label(sg.decode(shape, face)).cpu().numpy()
        for c in range(n):
            canvas.paste(r, c, mask_to_rgb(labels[c], draw_type=1))
    if out_path:
        canvas.save(out_path)
    return canvas.img


@torch.inference_mode()
def transfer_matrix_canvas(editor, images: List[np.ndarray],
                           out_path: Optional[str] = None) -> np.ndarray:
    """n x n hair transfers: row r's face and label with column c's hair
    code."""
    n = len(images)
    analyses = [editor.analyze_image(im) for im in images]
    canvas = Canvas(n, n, cell=editor.cfg.edit_size)
    for r in range(n):
        feats = torch.cat([analyses[c]['hair_feature'] for c in range(n)])
        imgs = _render_hair(editor, analyses[r]['sean_codes'],
                            analyses[r]['label'], feats)
        for c, im in enumerate(imgs):
            canvas.paste(r, c, to_uint8(im))
    if out_path:
        canvas.save(out_path)
    return canvas.img
