# The editing core: every model of the main path behind one object.
#
# Port of ctrlhair_tpu/pipeline/editor.py (HairEditorTPU), the part on the
# interactive path:
#   * analyze: parse at 512 px -> nearest resize to the edit size -> shape
#     codes and mask decode -> SEAN codes -> colour (uint8 HSV) and
#     texture/curliness latents;
#   * output: EigenGAN hair code -> swap into the SEAN codes -> SEAN render
#     under the median style fallback -> mask dilation + Poisson blend, whose
#     CG solve is the CUDA kernel csrc/masked_cg.cu on a card.
# PyTorch runs eagerly, so the functional stages are plain methods; the
# public ones run under torch.inference_mode.  The editor runs on one CUDA
# device unless the caller asks for the CPU: with no card and no explicit
# device it raises rather than fall back.
# The session on top of it is pipeline/backend.Backend.  The photo helpers
# of the JAX editor come along: crop_face (FFHQ alignment from the learned
# landmarks, ops/crop.py), get_hair_color (mean colour of the eroded hair at
# 1024 px) and the instance transfer (generate_by_sean,
# generate_instance_transfer_img).
# warm_start runs every interactive stage once on zero-filled inputs, as
# the JAX editor's warm start does: there it loads the compiled programs,
# here it builds and loads the kernels' libraries, lets cuDNN pick its
# algorithms and grows the caching allocator before the first request.
# The stages of an edit, _edit_render, _decode_mask and _blend, each open a
# span (utils/profiling.py: render, decode_mask, blend) that a profiler or
# recording() sees; a stage replayed as a CUDA graph keeps its span around
# the replay.  On a card the render is one: _edit_render runs its body
# through pipeline/stage_graph.StageGraphs, which captures it at the second
# call of each input signature (batch size, feature given or not, the
# inputs' layouts) and replays it after, its span's `graph` attribute saying
# which.  A cast or move of the editor (_apply) or
# load_state_dict(assign=True) rebinds the tensors the graphs read and drops
# them; the models' compute dtypes are part of the signature.

from __future__ import annotations

import os
import threading
import warnings
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from ctrlhair_tpu_torch.config import PipelineConfig
from ctrlhair_tpu_torch.constants import (
    BACKGROUND_IDX, CELEBA_TO_BISENET, HAIR_IDX, NUM_CLASSES)
from ctrlhair_tpu_torch.models.bisenet import BiSeNet, normalize_imagenet
from ctrlhair_tpu_torch.models.color_texture import (
    CTDiscriminator, Predictor, make_generator)
from ctrlhair_tpu_torch.models.layers import DTYPES, init_parameters_
from ctrlhair_tpu_torch.models.sean import SEAN
from ctrlhair_tpu_torch.models.shape import ShapeGenerator
from ctrlhair_tpu_torch.ops.morphology import dilate, erode
from ctrlhair_tpu_torch.ops.poisson_pallas import poisson_blend_fused
from ctrlhair_tpu_torch.ops.resize import resize_bilinear_nhwc, resize_nearest
from ctrlhair_tpu_torch.pipeline.latent import Latent
from ctrlhair_tpu_torch.pipeline.latent import interpolate as \
    latent_interpolate
from ctrlhair_tpu_torch.pipeline.stage_graph import StageGraphs
from ctrlhair_tpu_torch.utils.colorspace import rgb_to_hsv_u8
from ctrlhair_tpu_torch.utils.masks import (
    label_to_one_hot, one_hot_to_label, split_hair_face)
from ctrlhair_tpu_torch.utils.profiling import span


# the fields of a Latent that _feature reads
_FEATURE_FIELDS = ('hsv', 'pca_std', 'curliness', 'texture')


def resolve_device(device=None) -> torch.device:
    """None means the first CUDA device, and raises when there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError('HairEditor: no CUDA device is available; '
                               "pass device='cpu' to run on the CPU")
        return torch.device('cuda', 0)
    device = torch.device(device)
    if device.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError(f'HairEditor: {device} requested but no CUDA '
                               'device is available')
        if device.index is None:
            device = torch.device('cuda', torch.cuda.current_device())
    return device


class HairEditor(nn.Module):
    """Holds every model of the main path and exposes its stages.

    Submodules are named as the JAX editor's parameter families ('sean',
    'bisenet', 'shape', 'ct_gen', 'ct_dis', 'rgb_pred', 'curliness_pred',
    plus the 'style_fallback' buffer), so `convert.from_flax` output loads
    with `load_state_dict`.
    """

    def __init__(self, cfg: PipelineConfig = PipelineConfig(),
                 device=None, seed: int = 0,
                 warm_batches: Optional[Sequence[int]] = None):
        """warm_batches: batch sizes to warm the interactive stages for on
        a background thread started once the parameters are drawn (see
        warm_start); join_warm() waits for it."""
        super().__init__()
        if not cfg.use_pallas_blend:
            raise ValueError('HairEditor: use_pallas_blend=False has no '
                             'counterpart in the port; the blend always '
                             'solves through ops.poisson_pallas.masked_cg')
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = DTYPES[cfg.compute_dtype]
        self._render_graphs = StageGraphs('render', self.device)
        code_dim = cfg.sean.style_dim
        with torch.device(self.device):
            self.sean = SEAN(cfg.sean, dtype=self.dtype)
            self.bisenet = BiSeNet(cfg.bisenet, dtype=self.dtype)
            self.shape = ShapeGenerator(cfg.shape, dtype=self.dtype)
            # the colour/texture MLPs run in float32, as the JAX editor
            # builds them
            self.ct_gen = make_generator(cfg.color_texture)
            self.ct_dis = CTDiscriminator(cfg.color_texture, code_dim)
            self.rgb_pred = Predictor(cfg.rgb_predictor, code_dim)
            self.curliness_pred = Predictor(cfg.curliness_predictor,
                                            code_dim)
            # median per-region style codes; zeros mean "no fallback"
            self.register_buffer('style_fallback',
                                 torch.zeros(NUM_CLASSES, code_dim))
        self.eval()
        self.requires_grad_(False)
        self.init_params(seed)
        self._warm_threads: List[threading.Thread] = []
        if warm_batches:
            self._warm_threads = self.warm_start(batch_sizes=warm_batches,
                                                 block=False)

    def join_warm(self) -> None:
        """Wait for the warm-up threads that warm_batches started."""
        for t in self._warm_threads:
            t.join()
        self._warm_threads = []

    # ------------------------------------------------------------------ init
    def _apply(self, *args, **kwargs):
        # every cast or move (.to(), .cuda(), .half(), ...) rebinds the
        # tensors the captured renders read
        graphs = self.__dict__.get('_render_graphs')
        if graphs is not None:
            graphs.clear()
        return super()._apply(*args, **kwargs)

    def load_state_dict(self, state_dict, strict: bool = True,
                        assign: bool = False):
        """nn.Module's; assign=True rebinds the tensors, and drops the
        captured renders."""
        if assign:
            self._render_graphs.clear()
        return super().load_state_dict(state_dict, strict=strict,
                                       assign=assign)

    def init_params(self, seed: int = 0) -> None:
        """Draw every parameter from its flax initialiser with one seeded
        generator (the numbers differ from JAX's, the distributions do
        not); BN running statistics start at mean 0, var 1; the style
        fallback at zero."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        init_parameters_(self, gen)
        self.style_fallback.zero_()

    def load_style_fallback(self, folder: str) -> None:
        """Load per-class median codes from <folder>/<class>/ACE.npy.

        Codes whose width does not match this config's style_dim are
        skipped with a warning, so a reduced config can point at the
        full-size tables."""
        codes = np.zeros(tuple(self.style_fallback.shape), np.float32)
        for i in range(NUM_CLASSES):
            path = os.path.join(folder, str(i), 'ACE.npy')
            if not os.path.exists(path):
                continue
            code = np.load(path)
            if code.shape != codes[i].shape:
                warnings.warn(f'style fallback {path}: shape {code.shape} '
                              f'!= configured {codes[i].shape}; skipping',
                              stacklevel=2)
                continue
            codes[i] = code
        self.style_fallback.copy_(torch.from_numpy(codes))

    def _as(self, x, dtype=None) -> torch.Tensor:
        """numpy array or tensor -> tensor on this editor's device (arrays
        are copied: they may be read-only views)."""
        if not isinstance(x, torch.Tensor):
            x = torch.tensor(np.asarray(x))
        return x.to(device=self.device, dtype=dtype)

    # ------------------------------------------------------------ functional
    def _to_parse_size(self, img_u8: torch.Tensor) -> torch.Tensor:
        """[N,H,W,3] uint8 -> [N,P,P,3] uint8 at the parser's input size:
        bilinear (align_corners=False) then rounded back to the uint8 grid,
        as the reference feeds its parser a resized uint8 image."""
        size = self.cfg.bisenet.input_size
        if img_u8.shape[1] == size and img_u8.shape[2] == size:
            return img_u8
        x = resize_bilinear_nhwc(img_u8.to(torch.float32), (size, size))
        return torch.clamp(torch.round(x), 0, 255).to(torch.uint8)

    def _parse(self, img_u8: torch.Tensor) -> torch.Tensor:
        """[N,S,S,3] uint8 (any size) -> [N,P,P] int32 CelebA label map."""
        x = img_u8.to(torch.float32)
        size = self.cfg.bisenet.input_size
        if x.shape[1] != size or x.shape[2] != size:
            x = torch.round(resize_bilinear_nhwc(x, (size, size)))
        logits = self.bisenet(normalize_imagenet(x / 255.0))
        # permuting the logit channels before the argmax == remapping the
        # BiSeNet labels to CelebA ids after it (a bijection)
        perm = torch.as_tensor(CELEBA_TO_BISENET, device=logits.device)
        logits = logits.index_select(-1, perm.long())
        return torch.argmax(logits, dim=-1).to(torch.int32)

    def _analyze_tail(self, img_u8: torch.Tensor,
                      label512: torch.Tensor) -> Dict[str, object]:
        """Analysis downstream of the parser."""
        s = self.cfg.edit_size
        label = resize_nearest(label512, (s, s))
        shape_code, face_code = self._encode_shape(label)
        regen_label = self._decode_mask(shape_code, face_code)

        img_f = img_u8.to(torch.float32) / 127.5 - 1.0
        sean_codes = self.sean.encode(img_f, label).float()
        hair_feature = sean_codes[:, HAIR_IDX]

        color = self.rgb_pred({'code': hair_feature})
        rgb_u8 = torch.clamp(torch.round(color['rgb_mean']), 0, 255)
        hsv = rgb_to_hsv_u8(rgb_u8).to(torch.float32)
        enc = self.ct_dis({'code': hair_feature})
        # the public latent is float32 whatever the compute dtype
        f32 = lambda t: t.to(torch.float32)
        latent = Latent(hsv=hsv, pca_std=f32(color['pca_std']),
                        curliness=f32(enc['noise_curliness']),
                        texture=f32(enc['noise']), shape=shape_code,
                        face=face_code)
        return {'label512': label512, 'label': label,
                'regen_label': regen_label, 'sean_codes': sean_codes,
                'hair_feature': hair_feature, 'latent': latent}

    def _decode_mask(self, shape_code, face_code) -> torch.Tensor:
        with span('decode_mask'):
            return one_hot_to_label(self.shape.decode(shape_code, face_code))

    def _encode_shape(self, label: torch.Tensor):
        """[N,S,S] label -> (shape_code [N,16], face_code [N,1024]) f32."""
        hair, face = split_hair_face(label_to_one_hot(label))
        shape_code = self.shape.encode_hair(hair)[1]
        face_code = self.shape.encode_face(face)
        return shape_code.float(), face_code.float()

    def _feature(self, latent: Latent) -> torch.Tensor:
        """latent -> hair style code [N, D]."""
        data = {'noise': latent.texture,
                'noise_curliness': latent.curliness,
                'rgb_mean': latent.rgb_mean(),
                'pca_std': latent.pca_std}
        return self.ct_gen(data)['code']

    def _render(self, sean_codes: torch.Tensor,
                label: torch.Tensor) -> torch.Tensor:
        """codes [N,19,D] + label [N,S,S] -> image [-1,1] NHWC; regions
        without a code take the median fallback."""
        has_code = torch.any(sean_codes != 0, dim=-1, keepdim=True)
        codes = torch.where(has_code, sean_codes, self.style_fallback[None])
        return self.sean.decode(label, codes)

    @staticmethod
    def _blend_inputs(face_img_u8, gen_img_f, face_label, target_label):
        """-> (source, target, mask) of the Poisson blend: the face keeps
        its gradients (mask 1) outside the hair of either label, dilated by
        13 px (5 px over the target's background); inside, the render."""
        res_mask = ((target_label == HAIR_IDX)
                    | (face_label == HAIR_IDX)).to(torch.float32)
        d13 = dilate(res_mask, 13)
        d5 = dilate(res_mask, 5)
        bg = (target_label == BACKGROUND_IDX).to(torch.float32)
        blend_mask = 1.0 - (d13 * (1 - bg) + d5 * bg)
        return (face_img_u8.to(torch.float32), gen_img_f * 127.5 + 127.5,
                blend_mask)

    def _blend(self, face_img_u8, gen_img_f, face_label, target_label):
        """Poisson-blend the generated hair onto the original face."""
        with span('blend'):
            out = poisson_blend_fused(
                *self._blend_inputs(face_img_u8, gen_img_f, face_label,
                                    target_label),
                iterations=self.cfg.poisson_iterations)
            return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)

    def _edit_render(self, sean_codes, label, latent: Latent,
                     feature: Optional[torch.Tensor] = None):
        """latent -> feature -> hair-code swap -> SEAN render (no blend);
        on a card a CUDA graph's replay from the second call of its input
        signature on."""
        given = ((feature,) if feature is not None else
                 tuple(getattr(latent, f) for f in _FEATURE_FIELDS))
        return self._render_graphs(
            self._edit_render_body, (sean_codes, label) + given,
            key=(self.sean.generator.dtype, self.ct_gen.dtype))

    def _edit_render_body(self, sean_codes, label, *given):
        """_edit_render on tensors alone: `given` is the feature, or the
        latent's _FEATURE_FIELDS."""
        if len(given) == 1:
            feature = given[0]
        else:
            feature = self._feature(Latent(
                **dict(zip(_FEATURE_FIELDS, given)), shape=None, face=None))
        codes = sean_codes.clone()
        codes[:, HAIR_IDX] = feature.to(codes.dtype)
        return self._render(codes, label)

    def _output(self, sean_codes, latent: Latent, face_img_u8, face_label,
                target_label):
        """Full edit: render under target_label, blend onto the face."""
        img = self._edit_render(sean_codes, target_label, latent)
        return self._blend(face_img_u8, img, face_label, target_label)

    def _output_refresh(self, sean_codes, latent: Latent, face_img_u8,
                        face_label):
        """Shape-editing tick: decode the mask from the latent, then render
        and blend under it.  Returns (edited image, decoded label)."""
        label = self._decode_mask(latent.shape, latent.face)
        return self._output(sean_codes, latent, face_img_u8, face_label,
                            label), label

    def _output_sweep(self, sean_codes, l1: Latent, l2: Latent, alphas,
                      face_img_u8, face_label, target_label):
        """Interpolate len(alphas) latents between two endpoints and
        render+blend each against one batch-1 input."""
        n = alphas.shape[0]
        lat = latent_interpolate(l1, l2, alphas[:, None])
        bcast = lambda t: t.expand((n,) + tuple(t.shape[1:]))
        return self._output(bcast(sean_codes), lat.map(bcast),
                            bcast(face_img_u8), bcast(face_label),
                            bcast(target_label))

    # ---------------------------------------------------------------- public
    def _latent(self, latent: Latent) -> Latent:
        return latent.map(lambda t: self._as(t, torch.float32))

    @torch.inference_mode()
    def parse(self, img_u8) -> torch.Tensor:
        return self._parse(self._as(img_u8, torch.uint8))

    @torch.inference_mode()
    def encode_shape(self, label):
        """[N,S,S] label -> (shape_code [N,16], face_code [N,1024])."""
        return self._encode_shape(self._as(label, torch.int32))

    @torch.inference_mode()
    def decode_mask(self, shape_code, face_code) -> torch.Tensor:
        """codes -> [N,S,S] int32 label."""
        return self._decode_mask(self._as(shape_code, torch.float32),
                                 self._as(face_code, torch.float32))

    @torch.inference_mode()
    def edit_render(self, sean_codes, label, latent: Latent,
                    feature=None) -> torch.Tensor:
        """The render without the blend -> [N,S,S,3] in [-1,1]."""
        if feature is not None:
            feature = self._as(feature, torch.float32)
        return self._edit_render(self._as(sean_codes, torch.float32),
                                 self._as(label, torch.int32),
                                 self._latent(latent), feature)

    @torch.inference_mode()
    def blend(self, face_img_u8, gen_img_f, face_label,
              target_label) -> torch.Tensor:
        """Poisson-blend a render onto the face -> [N,S,S,3] uint8."""
        return self._blend(self._as(face_img_u8, torch.uint8),
                           self._as(gen_img_f),
                           self._as(face_label, torch.int32),
                           self._as(target_label, torch.int32))

    @torch.inference_mode()
    def analyze_tail(self, img_u8, label512) -> Dict[str, object]:
        return self._analyze_tail(self._as(img_u8, torch.uint8),
                                  self._as(label512, torch.int32))

    @torch.inference_mode()
    def analyze(self, img_u8, img_parse_u8) -> Dict[str, object]:
        """The analysis of a batch: img_u8 [N,S,S,3] at the edit size,
        img_parse_u8 [N,P,P,3] the same photos for the parser."""
        return self._analyze_tail(
            self._as(img_u8, torch.uint8),
            self._parse(self._as(img_parse_u8, torch.uint8)))

    @torch.inference_mode()
    def analyze_image(self, img_u8: np.ndarray) -> Dict[str, object]:
        """Host entry: one uint8 RGB image of any size -> analysis dict."""
        s = self.cfg.edit_size
        img = self._as(img_u8, torch.uint8)[None]
        if tuple(img.shape[1:3]) != (s, s):
            img256 = torch.clamp(torch.round(resize_bilinear_nhwc(
                img.to(torch.float32), (s, s))), 0, 255).to(torch.uint8)
        else:
            img256 = img
        label512 = self._parse(self._to_parse_size(img))
        return self._analyze_tail(img256, label512)

    @torch.inference_mode()
    def output(self, sean_codes, latent: Latent, face_img_u8, face_label,
               target_label) -> torch.Tensor:
        return self._output(self._as(sean_codes, torch.float32),
                            self._latent(latent),
                            self._as(face_img_u8, torch.uint8),
                            self._as(face_label, torch.int32),
                            self._as(target_label, torch.int32))

    @torch.inference_mode()
    def output_refresh(self, sean_codes, latent: Latent, face_img_u8,
                       face_label):
        return self._output_refresh(self._as(sean_codes, torch.float32),
                                    self._latent(latent),
                                    self._as(face_img_u8, torch.uint8),
                                    self._as(face_label, torch.int32))

    @torch.inference_mode()
    def output_sweep(self, sean_codes, l1: Latent, l2: Latent, alphas,
                     face_img_u8, face_label, target_label) -> torch.Tensor:
        return self._output_sweep(self._as(sean_codes, torch.float32),
                                  self._latent(l1), self._latent(l2),
                                  self._as(alphas, torch.float32),
                                  self._as(face_img_u8, torch.uint8),
                                  self._as(face_label, torch.int32),
                                  self._as(target_label, torch.int32))

    # ------------------------------------------------------------ warm start
    def warm_start(self, batch_sizes: Sequence[int] = (1,),
                   block: bool = True) -> List[threading.Thread]:
        """Run every interactive stage once ahead of its first real use,
        on zero-filled inputs at this editor's sizes: the JAX editor's list
        of jobs, output, output_refresh and decode_mask for each batch
        size, then parse and analyze_tail at batch 1 (the interactive
        analysis) and analyze at larger batches.  The stages run under
        inference mode, so no parameter, buffer or session changes.  On a
        card output renders a batch size eagerly and output_refresh
        captures its render's CUDA graph, so the graphs are captured here.

        cuDNN keeps part of its state per thread, so a server warms the
        thread that serves (ui/web.WebEditor).  With block=False the jobs
        run on one daemon thread, which is returned; else they run here and
        an empty list is returned."""
        s, p = self.cfg.edit_size, self.cfg.bisenet.input_size
        zeros = lambda *shape, dtype=torch.float32: torch.zeros(
            shape, dtype=dtype, device=self.device)

        def latent(b):
            return Latent(hsv=zeros(b, 3), pca_std=zeros(b, 1),
                          curliness=zeros(b, 1),
                          texture=zeros(b, self.cfg.color_texture.noise_dim),
                          shape=zeros(b, self.cfg.shape.hair_dim),
                          face=zeros(b, self.cfg.shape.face_dim))

        jobs = []
        for b in batch_sizes:
            codes = zeros(b, NUM_CLASSES, self.cfg.sean.style_dim)
            img = zeros(b, s, s, 3, dtype=torch.uint8)
            label = zeros(b, s, s, dtype=torch.int32)
            jobs.append((self.output, (codes, latent(b), img, label, label)))
            jobs.append((self.output_refresh, (codes, latent(b), img, label)))
            jobs.append((self.decode_mask, (latent(b).shape, latent(b).face)))
            img_p = zeros(b, p, p, 3, dtype=torch.uint8)
            if b == 1:
                jobs.append((self.parse, (img_p,)))
                jobs.append((self.analyze_tail,
                             (img, zeros(b, p, p, dtype=torch.int32))))
            else:
                jobs.append((self.analyze, (img, img_p)))

        def run_all():
            for f, args in jobs:
                f(*args)
            if self.device.type == 'cuda':
                torch.cuda.synchronize(self.device)

        if block:
            run_all()
            return []
        t = threading.Thread(target=run_all, daemon=True,
                             name='editor-warm-start')
        t.start()
        return [t]

    # ----------------------------------------------------- photo helpers
    @torch.inference_mode()
    def crop_face(self, img_rgb: np.ndarray,
                  output_size: Optional[int] = None) -> np.ndarray:
        """FFHQ-align and crop a face photo to `output_size` (the edit size
        by default) (ref: hair_editor.py:312-329).  The landmarks come from
        ops.landmarks' 'auto' estimator on this editor's device: the learned
        net on the photo, else the contour of its parse."""
        from ctrlhair_tpu_torch.ops.crop import recreate_aligned_image
        from ctrlhair_tpu_torch.ops.landmarks import estimate_landmarks_68
        img_rgb = np.asarray(img_rgb, np.uint8)
        label512 = self._parse(self._to_parse_size(
            self._as(img_rgb, torch.uint8)[None]))[0]
        # landmarks are normalised to the (squashed) parse square: x scales
        # by the width, y by the height
        lm68 = estimate_landmarks_68(
            label512.cpu().numpy(), image=img_rgb, device=self.device) \
            * np.array([img_rgb.shape[1], img_rgb.shape[0]], np.float64)
        out, _ = recreate_aligned_image(img_rgb, lm68,
                                        output_size or self.cfg.edit_size)
        return out

    @torch.inference_mode()
    def get_hair_color(self, img_rgb: np.ndarray) -> np.ndarray:
        """Mean RGB [3] over the hair region eroded by 19 px, at 1024 px
        (ref: hair_editor.py:233-244)."""
        img = self._as(np.asarray(img_rgb, np.uint8), torch.uint8)[None]
        label512 = self._parse(self._to_parse_size(img))
        label = resize_nearest(label512, (1024, 1024))[0]
        img = resize_bilinear_nhwc(img.to(torch.float32), (1024, 1024))[0]
        hair = erode((label == HAIR_IDX).to(torch.float32), 19)
        w = hair[..., None]
        mean = (img * w).sum(dim=(0, 1)) / torch.clamp(w.sum(dim=(0, 1)),
                                                       min=1.0)
        return mean.cpu().numpy()

    @torch.inference_mode()
    def generate_by_sean(self, face_codes, hair_code,
                         target_label) -> np.ndarray:
        """Render face codes [19,D] with the hair code [D] swapped in under
        `target_label` [S,S] -> [S,S,3] in [-1,1] (ref: hair_editor.py:
        181-206)."""
        codes = self._as(face_codes, torch.float32)[None].clone()
        codes[:, HAIR_IDX] = self._as(hair_code, torch.float32)
        img = self._render(codes, self._as(target_label, torch.int32)[None])
        return img[0].float().cpu().numpy()

    @torch.inference_mode()
    def generate_instance_transfer_img(self, face_img, face_label, hair_img,
                                       hair_label, target_label,
                                       edit_latent: Optional[Latent] = None
                                       ) -> np.ndarray:
        """Instance-level hair transfer: encode both photos, swap the hair
        code (or the one an edited latent generates) into the face's codes,
        render (ref: hair_editor.py:208-231)."""
        def encode(img, label):
            img_f = self._as(img, torch.float32)[None] / 127.5 - 1.0
            return self.sean.encode(
                img_f, self._as(label, torch.int32)[None]).float()

        face_codes = encode(face_img, face_label)
        hair_codes = (face_codes if hair_img is None
                      else encode(hair_img, hair_label))
        hair_code = hair_codes[0, HAIR_IDX]
        if edit_latent is not None:
            hair_code = self._feature(self._latent(edit_latent))[0]
        return self.generate_by_sean(face_codes[0], hair_code, target_label)
