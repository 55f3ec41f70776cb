# Stateful editing session — the public Backend API.
#
# Port of ctrlhair_tpu/pipeline/backend.py.  Method-level parity with the
# reference Backend (ref: ui/backend.py:40-462): same names, same slider
# semantics (including the (val+max)/2/max*100+20 pca_std mapping,
# ref :204-206), same transfer/interpolation contracts.  The heavy lifting
# is HairEditor's; this class keeps the session state and the host-side
# glue.  The session's tensors (latents, SEAN codes, cached parses, the
# current mask) live on the editor's device; images and label maps handed
# back to the caller are numpy arrays, as in the JAX package.
#
# Weights: Backend() with no editor builds a HairEditor (on `device`, the
# first CUDA device by default) and boots from the checkout's
# model_trained/: every family checkpoint found there
# (convert.load.load_trained_root), the median style codes, the HSV table
# and the direction pickles, as the JAX Backend does.  A caller that passes
# an editor keeps its weights unless it names a trained_root.

from __future__ import annotations

import os
import pickle
from typing import List, Optional

import numpy as np
import torch

from ctrlhair_tpu_torch.config import PipelineConfig
from ctrlhair_tpu_torch.constants import HAIR_IDX, SHAPE_DIM, TEXTURE_DIM
from ctrlhair_tpu_torch.convert.load import load_trained_root
from ctrlhair_tpu_torch.ops.resize import resize_bilinear_nhwc
from ctrlhair_tpu_torch.pipeline import latent as latent_ops
from ctrlhair_tpu_torch.pipeline.direction_finder import load_directions
from ctrlhair_tpu_torch.pipeline.editor import HairEditor
from ctrlhair_tpu_torch.pipeline.latent import Latent
from ctrlhair_tpu_torch.utils.color_stats import DistTranslation
from ctrlhair_tpu_torch.utils.colorspace import hsv_to_rgb_u8, rgb_to_hsv_u8
from ctrlhair_tpu_torch.utils.image import mask_to_rgb, write_rgb
from ctrlhair_tpu_torch.utils.masks import one_hot_to_label
from ctrlhair_tpu_torch.utils.profiling import span


def _to_u8(img_f: torch.Tensor) -> torch.Tensor:
    """A render in [-1,1] -> uint8 (round to nearest, as the JAX Backend)."""
    return torch.clamp(torch.round(img_f.float() * 127.5 + 127.5), 0,
                       255).to(torch.uint8)


def _readback(t: torch.Tensor) -> np.ndarray:
    """A request's images (or mask) to the host: the request's one sync,
    where the host waits out the device's lag."""
    with span('readback'):
        return t.cpu().numpy()


def repo_path(rel: str) -> str:
    """A path inside this checkout."""
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(repo, rel)


class Backend:
    """Interactive editing session (ref: ui/backend.py:40-462)."""

    def __init__(self, maximum_value_fe: float = 2.5, blending: bool = True,
                 cfg: PipelineConfig = PipelineConfig(),
                 editor: Optional[HairEditor] = None, seed: int = 0,
                 hsv_table=None, trained_root: Optional[str] = 'auto',
                 device=None):
        """`trained_root='auto'` loads the checkout's model_trained/ when
        this Backend builds its own editor (editor=None), and nothing into a
        given editor; name a directory to load it either way.  `device` is
        where a built editor lives (None: the first CUDA device)."""
        self.cfg = cfg
        self.editor = editor if editor is not None else HairEditor(
            cfg, device=device, seed=seed)
        self.device = self.editor.device
        if trained_root == 'auto':
            trained_root = (repo_path('model_trained') if editor is None
                            else None)
        # {family: step} of the checkpoints loaded into the editor
        self.loaded_families = {}
        if trained_root and os.path.isdir(trained_root):
            self.loaded_families = load_trained_root(self.editor,
                                                     trained_root)
            median = os.path.join(trained_root, 'mean_style_code', 'median')
            if os.path.isdir(median):
                self.editor.load_style_fallback(median)
        if hsv_table is None and trained_root:
            # dataset-stats contract: the HSV slider CDF table ships with
            # the trained weights (ref: dataset_info_ctrlhair/
            # hsv_stat_dict_ordered.pkl, color_from_hsv_to_gaussian.py:18)
            table_path = os.path.join(trained_root,
                                      'hsv_stat_dict_ordered.pkl')
            if os.path.exists(table_path):
                with open(table_path, 'rb') as f:
                    hsv_table = pickle.load(f)
        self.maximum_value_fe = maximum_value_fe
        self.blending = blending
        self.dist_translation = DistTranslation(table=hsv_table,
                                                device=self.device)

        # semantic directions: curated pickles if available (the reference's
        # texture_dir_used/shape_dir_used contract, hair_editor.py:82-119),
        # else deterministic orthonormal defaults (see latent.py)
        def dirs(name: str, dim: int, n: int) -> List[np.ndarray]:
            """Curated directions, padded with deterministic orthonormal
            defaults up to the UI's fixed slider count (a partially-curated
            dir must not shrink the slider set).  A degenerate (near-zero)
            pickle is replaced slot-by-slot with the default: the slider
            semantics (projection set TO the slider value,
            ref: ui/backend.py:450-462) need unit-norm directions, and a
            zero vector would make its slider permanently dead."""
            loaded = load_directions(
                os.path.join(trained_root or 'model_trained', name)) or []
            defaults = latent_ops.semantic_directions(dim, n)
            out = (list(loaded) + list(defaults))[:max(n, len(loaded))]
            for i, d in enumerate(out):
                if float(np.linalg.norm(np.asarray(d))) < 1e-3:
                    out[i] = np.asarray(defaults[i % len(defaults)])
            return out

        self.shape_dirs = dirs('shape_dir_used', SHAPE_DIM, 4)
        self.texture_dirs = dirs('texture_dir_used', TEXTURE_DIM, 2)
        self._rng = np.random.default_rng(seed)

        self._parse512 = {}            # 'input'/'target' -> [P,P] label,
        #                                on the device
        self._parse512_np = {}         # host copies (filled with landmarks)
        self._lm81 = {}                # 'input'/'target' -> [81,2] or None
        self.input_img = None          # uint8 [S,S,3], numpy
        self.target_img = None
        self.input_mask = None         # parsed label [S,S], numpy
        self.target_mask = None
        self.cur_mask = None           # regenerated label [S,S] (lazy)
        self.cur_latent: Optional[Latent] = None
        self.target_latent: Optional[Latent] = None
        self.input_sean_code = None    # [1,19,D]
        self.input_hair_feature = None
        self.target_hair_feature = None
        self.warp_target = None        # last shape transfer's composite
        self._input_dev = None         # cached (img [1,S,S,3], mask [1,S,S])

    def crop_face(self, img_rgb: np.ndarray, save_path=None) -> np.ndarray:
        """FFHQ-align a raw photo to the edit size (ref: hair_editor.py:
        312-329); written to `save_path` as a PNG when one is given."""
        out = self.editor.crop_face(img_rgb)
        if save_path:
            write_rgb(save_path, out)
        return out

    def _tensor(self, x, dtype=torch.float32) -> torch.Tensor:
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    # ------------------------------------------------------------- analysis
    def parse_img(self, img_rgb: np.ndarray, target_img: bool = False):
        res = self.editor.analyze_image(np.asarray(img_rgb, np.uint8))
        img_ts = self._resized256(img_rgb)
        # the regenerated mask stays on the device (see cur_mask)
        out_mask = None if target_img else res['regen_label'][0]
        mask = res['label'][0].cpu().numpy()
        # cache the parse for shape transfers (on the device); landmarks
        # are derived on first use (see _landmarks81)
        key = 'target' if target_img else 'input'
        self._parse512[key] = res['label512'][0]
        self._parse512_np.pop(key, None)
        self._lm81[key] = None
        return (img_ts, out_mask, res['latent'], mask,
                res['sean_codes'], res['hair_feature'])

    def _landmarks81(self, key: str):
        """Cached [81,2] landmarks from the cached parse — the target/input
        geometry does not change between transfers, so repeated transfers
        skip both the parser and the host landmark estimation (the reference
        re-runs dlib+BiSeNet per transfer,
        ref: wrap_codes/mask_adaptor.py:202-212)."""
        if self._lm81.get(key) is None and self._parse512.get(key) is not None:
            from ctrlhair_tpu_torch.ops.landmarks import estimate_landmarks_81
            # ONE host readback per image, for the landmark estimation
            self._parse512_np[key] = self._parse512[key].cpu().numpy()
            img = self.target_img if key == 'target' else self.input_img
            self._lm81[key] = estimate_landmarks_81(
                self._parse512_np[key],
                image=None if img is None else np.asarray(img),
                device=self.device)
        return self._lm81.get(key)

    @torch.inference_mode()
    def _resized256(self, img_rgb: np.ndarray) -> np.ndarray:
        s = self.cfg.edit_size
        if img_rgb.shape[0] == s and img_rgb.shape[1] == s:
            return np.asarray(img_rgb, np.uint8)
        out = resize_bilinear_nhwc(
            self._tensor(np.asarray(img_rgb))[None], (s, s))
        return torch.clamp(torch.round(out[0]), 0, 255).to(
            torch.uint8).cpu().numpy()

    def set_input_img(self, img_rgb: np.ndarray):
        (self.input_img, self.cur_mask, self.cur_latent, self.input_mask,
         self.input_sean_code, self.input_hair_feature) = self.parse_img(
            img_rgb)
        return self.input_img, mask_to_rgb(self.cur_mask, draw_type=1)

    def set_target_img(self, img_rgb: np.ndarray):
        (self.target_img, _, self.target_latent, self.target_mask,
         _, self.target_hair_feature) = self.parse_img(img_rgb, True)
        return self.target_img, mask_to_rgb(self.target_mask, draw_type=1)

    # -------------------------------------------------------------- render
    def output(self, target_latent: Optional[Latent] = None,
               feature=None) -> np.ndarray:
        """Render the edited image (ref: ui/backend.py:147-175)."""
        with span('backend.output', images=1):
            if target_latent is not None and feature is None and self.blending:
                # one tick: mask decode + render + blend, ONE host sync (the
                # mask stays on the device)
                face, flabel = self._input_batched()
                out, mask = self.editor.output_refresh(
                    self.input_sean_code, target_latent, face, flabel)
                self.cur_mask = mask[0]   # device tensor: lazy
                return _readback(out[0])
            if target_latent is None:
                target_latent = self.cur_latent
                target_mask = self._cur_mask_batched()
            else:
                target_mask = self.editor.decode_mask(target_latent.shape,
                                                      target_latent.face)
                self.cur_mask = target_mask[0]   # device tensor: lazy
            img = self.editor.edit_render(self.input_sean_code, target_mask,
                                          target_latent, feature)
            if self.blending:
                face, flabel = self._input_batched()
                out = self.editor.blend(face, img, flabel, target_mask)
                return _readback(out[0])
            return _readback(_to_u8(img[0]))

    # --------------------------------------------------------------- edits
    def change_curliness(self, val: float) -> None:
        self.cur_latent = self.cur_latent.replace(
            curliness=torch.full_like(self.cur_latent.curliness, val))

    def change_color(self, val: float, idx: int) -> None:
        """idx 0..2 = HSV via empirical-CDF mapping; 3 = variance
        (ref: ui/backend.py:196-209)."""
        if idx == 3:
            v = (val + self.maximum_value_fe) / 2 / self.maximum_value_fe
            self.cur_latent = self.cur_latent.replace(
                pca_std=torch.full_like(self.cur_latent.pca_std,
                                        v * 100 + 20))
        else:
            hsv = self.cur_latent.hsv.clone()
            hsv[0, idx] = self.dist_translation.gaussian_to_val(idx, val)
            self.cur_latent = self.cur_latent.replace(hsv=hsv)

    def change_shape(self, val: float, idx: int) -> None:
        # continue_change_with_direction already refreshes for 'shape'
        self.continue_change_with_direction('shape', self.shape_dirs[idx],
                                            val)

    def change_texture(self, val: float, idx: int) -> None:
        self.continue_change_with_direction('texture',
                                            self.texture_dirs[idx], val)

    def continue_change_with_direction(self, att_name: str, direction,
                                       val: float) -> None:
        vec = getattr(self.cur_latent, att_name)
        moved = latent_ops.apply_direction(vec, self._tensor(direction), val)
        self.cur_latent = self.cur_latent.replace(**{att_name: moved})
        if att_name == 'shape':
            self._refresh_mask_async()

    # ---------------------------------------------------------- frontend IO
    def get_curliness_be2fe(self):
        return float(self.cur_latent.curliness[0, 0])

    def get_color_be2fe(self):
        hsv = self.cur_latent.hsv[0]
        c = [float(self.dist_translation.val_to_gaussian(i, hsv[i]))
             for i in range(3)]
        var_fe = (float(self.cur_latent.pca_std[0, 0]) - 20) / 100 \
            * 2 * self.maximum_value_fe - self.maximum_value_fe
        return c[0], c[1], c[2], var_fe

    def get_shape_be2fe(self):
        return [float(latent_ops.projection(
            self.cur_latent.shape, self._tensor(self.shape_dirs[i]))[0])
            for i in range(4)]

    def get_texture_be2fe(self):
        return [float(latent_ops.projection(
            self.cur_latent.texture, self._tensor(self.texture_dirs[i]))[0])
            for i in range(2)]

    # ------------------------------------------------------------- transfer
    def transfer_latent_representation(self, flag: str,
                                       refresh: bool = True) -> None:
        """(ref: ui/backend.py:266-302)"""
        if flag == 'shape':
            from ctrlhair_tpu_torch.ops.warp import \
                warp_hair_mask_between_images
            # backend inputs are already aligned by set_input_img, so the
            # 1024 crop stage is skipped (ref: ui/backend.py:275
            # need_crop=False).  The cached parses go in as they lie: on a
            # card the warp's rasteriser is the CUDA kernel and the
            # composite never leaves the device.
            lm_t = self._landmarks81('target')
            lm_i = self._landmarks81('input')
            wt = warp_hair_mask_between_images(
                self.target_img, self.input_img,
                editor=self.editor, need_crop=False,
                hair_parse512=self._parse512.get('target'),
                face_parse512=self._parse512.get('input'),
                hair_lm81=lm_t, face_lm81=lm_i)
            self.warp_target = wt      # [S,S] int32, on the device
            shape_code, face_code = self.editor.encode_shape(wt[None])
            self.target_latent = self.target_latent.replace(
                shape=shape_code, face=face_code)
            # pre-transfer refresh replicated from the reference
            # (ui/backend.py:287): decodes the still-untransferred latent;
            # with refresh=True the post-transfer refresh supersedes it
            self._refresh_mask_async()

        self.cur_latent = latent_ops.transfer(self.cur_latent,
                                              self.target_latent, flag)
        if flag == 'shape' and refresh:
            self._refresh_mask_async()

    # cur_mask is device-backed and materialised lazily: per-tick internal
    # refreshes (change_shape -> output) never force a host sync for it —
    # the mask rides the device queue into the next edit, and only an actual
    # host read (get_cur_mask, .cur_mask) synchronises.
    @property
    def cur_mask(self):
        if self._cur_mask_np is None and self._cur_mask_dev is not None:
            self._cur_mask_np = _readback(self._cur_mask_dev)
        return self._cur_mask_np

    @cur_mask.setter
    def cur_mask(self, value):
        if value is None or isinstance(value, np.ndarray):
            self._cur_mask_np, self._cur_mask_dev = value, None
        else:
            self._cur_mask_np, self._cur_mask_dev = None, value

    def _cur_mask_batched(self) -> torch.Tensor:
        """[1,S,S] device label, without a host round trip if possible."""
        if self._cur_mask_dev is not None:
            return self._cur_mask_dev[None]
        return self._tensor(self._cur_mask_np, torch.int32)[None]

    def _refresh_mask_async(self,
                            target_latent: Optional[Latent] = None) -> None:
        """Decode the mask for the current latent WITHOUT reading it back;
        the device tensor chains into the next edit on the stream."""
        if target_latent is None:
            target_latent = self.cur_latent
        out = self.editor.decode_mask(target_latent.shape,
                                      target_latent.face)
        self.cur_mask = out[0]   # device tensor: lazy

    def refresh_cur_mask(self, target_latent: Optional[Latent] = None):
        self._refresh_mask_async(target_latent)
        return self.cur_mask, mask_to_rgb(self.cur_mask, draw_type=1)

    def get_cur_mask(self):
        return mask_to_rgb(self.cur_mask, draw_type=1)

    # ----------------------------------------------------- colour utilities
    @staticmethod
    def tensor_hsv_to_rgb(hsv) -> torch.Tensor:
        """uint8-range HSV -> RGB (ref: ui/backend.py:108-115)."""
        return hsv_to_rgb_u8(torch.as_tensor(hsv)).to(torch.float32)

    @staticmethod
    def tensor_rgb_to_hsv(rgb) -> torch.Tensor:
        """uint8-range RGB -> HSV (ref: ui/backend.py:117-125)."""
        return rgb_to_hsv_u8(torch.as_tensor(rgb)).to(torch.float32)

    @staticmethod
    def interpolate_hsv(hsv1, hsv2, alpha) -> torch.Tensor:
        """HSV lerp through RGB space (ref: ui/backend.py:323-332)."""
        return latent_ops.interpolate_hsv(torch.as_tensor(hsv1),
                                          torch.as_tensor(hsv2), alpha)

    # -------------------------------------------------------- interpolation
    def interpolate(self, l1: Latent, l2: Latent, alpha) -> Latent:
        res = latent_ops.interpolate(l1, l2, alpha)
        return res.replace(face=self.cur_latent.face)

    def interpolate_each_att(self, l1: Latent, l2: Latent, alpha,
                             att_name: str) -> Latent:
        res = latent_ops.interpolate_attribute(self.cur_latent, l1, l2,
                                               alpha, att_name)
        return res.replace(face=self.cur_latent.face)

    def interpolate_triple(self, l1, l2, l3, a1, a2, a3) -> Latent:
        res = latent_ops.interpolate_triple(l1, l2, l3, a1, a2, a3)
        return res.replace(face=self.cur_latent.face)

    # ------------------------------------------------------------- sampling
    def _normal(self, shape) -> torch.Tensor:
        """Standard normal draws from the session's numpy generator (the
        same draws as the JAX Backend makes from the same seed)."""
        return self._tensor(self._rng.standard_normal(shape))

    def get_random_texture(self) -> None:
        self.cur_latent = self.cur_latent.replace(
            texture=self._normal((1, TEXTURE_DIM)))

    def get_random_shape(self) -> None:
        self.cur_latent = self.cur_latent.replace(
            shape=self._normal((1, SHAPE_DIM)))
        self._refresh_mask_async()

    def get_random_curliness(self) -> None:
        self.cur_latent = self.cur_latent.replace(
            curliness=self._normal((1, 1)))

    # ------------------------------------------------------------- batched
    def output_batch(self, latents: Latent) -> np.ndarray:
        """Render a BATCH of latents against the current input at once (the
        reference renders one edit at a time).

        latents: Latent with leading batch dim N -> [N, S, S, 3] uint8.
        """
        n = latents.texture.shape[0]
        with span('backend.output_batch', images=n):
            codes = self.input_sean_code.expand(n, -1, -1)
            mask = self._cur_mask_batched().expand(n, -1, -1)
            if self.blending:
                face1, flabel1 = self._input_batched()
                out = self.editor.output(codes, latents,
                                         face1.expand(n, -1, -1, -1),
                                         flabel1.expand(n, -1, -1), mask)
                return _readback(out)
            img = self.editor.edit_render(codes, mask, latents)
            return _readback(_to_u8(img))

    def _input_batched(self):
        """Device-cached (face image, face label) batch-1 pair; invalidated
        by set_input_img storing new host arrays."""
        if self._input_dev is None or self._input_dev[2] is not self.input_img:
            self._input_dev = (
                self._tensor(self.input_img, torch.uint8)[None],
                self._tensor(self.input_mask, torch.int32)[None],
                self.input_img)
        return self._input_dev[0], self._input_dev[1]

    def interpolation_sweep(self, l1: Latent, l2: Latent, alphas,
                            readback: bool = True):
        """Render latent interpolations for every alpha as one batch
        (interpolate + render + blend, editor.output_sweep) — vs the
        reference's per-alpha backend calls.  Host traffic per sweep: the
        [N] alpha vector up, plus (optionally) one uint8 batch down."""
        with span('backend.sweep', images=len(alphas)):
            a = self._tensor(alphas)
            l1 = l1.replace(face=self.cur_latent.face)
            if self.blending:
                face, flabel = self._input_batched()
                out = self.editor.output_sweep(
                    self.input_sean_code, l1, l2, a, face, flabel,
                    self._cur_mask_batched())
                return _readback(out) if readback else out
            n = a.shape[0]
            lats = latent_ops.interpolate(l1, l2, a[:, None])
            lats = lats.map(lambda x: x.expand((n,) + tuple(x.shape[1:])))
            return self.output_batch(lats)

    def random_texture_sweep(self, n: int) -> np.ndarray:
        """n random texture samples rendered in one batch."""
        base = self.cur_latent
        tile = lambda t: t.repeat(n, 1)
        lats = Latent(
            hsv=tile(base.hsv), pca_std=tile(base.pca_std),
            curliness=self._normal((n, 1)),
            texture=self._normal((n, TEXTURE_DIM)),
            shape=tile(base.shape), face=tile(base.face))
        return self.output_batch(lats)

    # ------------------------------------------------------------ mask edit
    @staticmethod
    def show_hair_region(mask, non_hair_value: int = 0):
        rgb = mask_to_rgb(mask, draw_type=1)
        rgb[np.asarray(mask) != HAIR_IDX] = non_hair_value
        return rgb

    @torch.inference_mode()
    def directly_change_hair_mask(self, hair_mask: np.ndarray) -> None:
        """Replace the hair region with a painted mask
        (ref: ui/backend.py:409-420)."""
        sg = self.editor.shape
        face_logit = sg.face_decoder(self.cur_latent.face).permute(0, 2, 3, 1)
        hm = self._tensor(np.asarray(hair_mask) == HAIR_IDX,
                          face_logit.dtype)[None, ..., None]
        lo, hi = face_logit.min(), face_logit.max()
        hair_logit = hm * (hi - lo + 2.0) + lo - 1.0
        mask = sg.merge_logits(hair_logit, face_logit)
        self.cur_mask = one_hot_to_label(mask)[0]   # device tensor: lazy
