# Typed configuration system (the port's own copy of ctrlhair_tpu/config.py:
# same dataclasses and field names, so a config reads the same on both sides).
#
# The reference uses addict dicts populated by CLI parsing at import time keyed
# on sys.argv[0] (ref: color_texture_branch/config.py:130-141) — a quirk this
# rebuild intentionally replaces with plain frozen dataclasses resolved
# explicitly by the caller.  Loss weights may be step-scheduled dicts
# ({step: weight}) consumed by training.losses.LossSchedule.

from __future__ import annotations

import dataclasses
from typing import Any, Mapping


@dataclasses.dataclass(frozen=True)
class SEANConfig:
    """SEAN generator/encoder config (ref: sean_codes/options/base_options.py:15-181)."""
    crop_size: int = 256
    semantic_nc: int = 19
    ngf: int = 64
    style_dim: int = 512
    num_up_layers: int = 5          # 'normal' mode: total 2x upsamples
    # SPADE-resnet middles between the head and the up chain (the reference
    # always has 2, generator.py:90-96); exposed so tiny dry-run builds can
    # shrink the graph (compile/trace cost scales with block count)
    num_middle_blocks: int = 2
    zencoder_ngf: int = 32
    spade_hidden: int = 128
    # additive learned per-channel noise inside ACE (ref normalization.py:111);
    # zeroed at inference for determinism.
    use_ace_noise: bool = False
    param_free_norm: str = 'syncbatch'  # 'syncbatch' | 'instance'
    spectral_norm: bool = True
    # rematerialise each SPADE-resnet block in the backward pass: trades
    # FLOPs for activation memory so training batches scale (jax.checkpoint)
    remat_blocks: bool = False
    # compute conv_gamma/conv_beta(middle_avg) by folding the 3x3 kernel
    # through the 19 region style vectors instead of convolving the dense
    # 512-channel map — exact (linearity), ~27x fewer FLOPs on those convs
    fold_style_convs: bool = True

    @property
    def start_size(self) -> int:
        return self.crop_size // (2 ** self.num_up_layers)


@dataclasses.dataclass(frozen=True)
class BiSeNetConfig:
    """Face parser config (ref: external_code/face_parsing/model.py:230-254)."""
    n_classes: int = 19
    input_size: int = 512
    # ResNet-18 = 2 BasicBlocks per stage (ref: resnet.py:58-80); 1 gives a
    # ResNet-10-style backbone for tiny dry-run builds (same collective
    # paths, half the trace/compile cost)
    blocks_per_stage: int = 2


@dataclasses.dataclass(frozen=True)
class PredictorConfig:
    """Frozen supervised predictor (ref: predictor/predictor_config.py:17-43)."""
    name: str = 'p004___pca_std'
    hidden_layer_num: int = 3
    hidden_dim: int = 256
    predict_dict: Mapping[str, int] = dataclasses.field(
        default_factory=lambda: {'rgb_mean': 3, 'pca_std': 1})
    norm: str = 'bn'
    activ: str = 'lrelu'
    dropout: float = 0.2
    style_dim: int = 512
    total_batch_size: int = 256
    total_step: int = 10000
    lr: float = 0.002
    beta1: float = 0.5
    beta2: float = 0.999
    # step-scheduled loss weights (ref: predictor_config.py:23,36-37);
    # None = loss absent for this predictor
    lambda_cls_curliness: Any = None
    lambda_rgb: Any = dataclasses.field(default_factory=lambda: {0: 1.0})
    lambda_pca_std: Any = dataclasses.field(default_factory=lambda: {0: 1.0})


def curliness_predictor_config() -> PredictorConfig:
    return PredictorConfig(
        name='p002___curliness', hidden_dim=32, dropout=0.5,
        predict_dict={'cls_curliness': 1}, total_step=7000,
        lambda_cls_curliness={0: 1.0, 200: 0.1, 400: 0.01, 2500: 0.001},
        lambda_rgb=None, lambda_pca_std=None)


def rgb_predictor_config() -> PredictorConfig:
    return PredictorConfig()


@dataclasses.dataclass(frozen=True)
class ColorTextureConfig:
    """Color & texture branch (ref: color_texture_branch/config.py:16-96)."""
    name: str = '045__color_texture_final'
    style_dim: int = 512
    noise_dim: int = 8
    curliness_dim: int = 1
    g_hidden_layer_num: int = 4
    d_hidden_layer_num: int = 4
    d_noise_hidden_layer_num: int = 3
    g_hidden_dim: int = 256
    d_hidden_dim: int = 256
    gen_mode: str = 'eigengan'
    g_norm: str = 'none'
    d_norm: str = 'none'
    g_activ: str = 'relu'
    d_activ: str = 'lrelu'
    gan_type: str = 'wgan_gp'
    use_rgb_cond: bool = True
    use_pca_std_cond: bool = True
    use_curliness: bool = True
    external_curliness_predictor: bool = True
    external_rgb_predictor: bool = True
    gan_input_from_encoder_prob: float = 0.3
    curliness_with_weight: bool = True
    # training
    total_step: int = 650100
    total_batch_size: int = 128
    lr_g: float = 0.0002
    lr_d: float = 0.0002
    beta1: float = 0.5
    beta2: float = 0.999
    lambda_adv: float = 1.0
    lambda_gp: float = 10.0
    lambda_rec: float = 1000.0
    lambda_info: float = 1.0
    lambda_info_curliness: float = 1.0
    lambda_rgb: float = 0.01
    lambda_pca_std: float = 0.01
    lambda_moment_1: float = 0.01
    lambda_moment_2: float = 0.01
    lambda_cls_curliness: Any = dataclasses.field(
        default_factory=lambda: {0: 0.1})
    lambda_rec_img: Any = dataclasses.field(
        default_factory=lambda: {0: 0.0, 600000: 1000.0})
    lambda_orthogonal: float = 0.1
    lambda_adv_noise: float = 1.0

    @property
    def subspace_dim(self) -> int:
        return self.noise_dim // self.g_hidden_layer_num

    @property
    def cond_dim(self) -> int:
        dim = 0
        if self.use_curliness:
            dim += self.curliness_dim
        if self.use_rgb_cond:
            dim += 3
        if self.use_pca_std_cond:
            dim += 1
        return dim


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """Shape branch / mask VAE-GAN (ref: shape_branch/config.py:16-95)."""
    name: str = '054__shape_final'
    img_size: int = 256
    hair_dim: int = 16
    face_dim: int = 1024
    pos_encoding_order: int = 10
    layer_num: int = 7
    hidden_in_channel: int = 32
    d_hidden_in_channel: int = 16
    max_channel: int = 2048
    g_norm: str = 'ln'
    d_norm: str = 'none'
    vae_hair_mode: bool = True
    d_hidden_dim: int = 256
    d_noise_hidden_layer_num: int = 3
    gan_type: str = 'hinge2'
    # training
    total_step: int = 380002
    total_batch_size: int = 4
    lr_g: float = 0.0002
    lr_d: float = 0.0001
    lr_dz: float = 0.00005
    beta1: float = 0.5
    beta2: float = 0.999
    lambda_adv: float = 1.0
    lambda_hair: float = 100.0
    lambda_non_hair: float = 100.0
    lambda_face: float = 20.0
    lambda_self_rec: float = 5.0
    lambda_kl: float = 0.1
    lambda_adv_noise: float = 1.0
    lambda_gp_0: float = 10.0
    lambda_gp_0_noise: float = 10.0
    random_ae_prob: float = 0.5
    # Optional branches, off in the shipped 054 config but expressible in the
    # reference config system (ref: shape_branch/solver.py:94-107,136-141,
    # 227-230).  lambda_info re-encodes the prior-noise decode and penalises
    # code reconstruction; the moments match the AE hair code's batch mean /
    # second moment; disturb_real_batch_mask adds renormalised uniform noise
    # to every mask the discriminator or encoders see.
    lambda_info: float = 0.0
    lambda_moment_1: float = 0.0
    lambda_moment_2: float = 0.0
    disturb_real_batch_mask: bool = False
    # Free-bits floor (nats/dim) under the KL term: 0.0 = the reference's
    # plain KL; > 0 stops the hair latent collapsing to the prior on short
    # runs (losses.kl_loss_free_bits).  Not a reference option.
    kl_free_bits: float = 0.0
    # Geometry supervision (not a reference option): weight on an MSE
    # between a linear head over the hair latent's posterior MEAN and
    # in-graph geometry statistics of the input hair mask (area, length,
    # top, forehead coverage, asymmetry, width).  The reference's 380k-step
    # schedule leaves the latent informative by brute force; short soaks
    # collapse (r4/r5: direction regression R^2 ~ 1e-4) — this term makes
    # the latent linearly encode exactly the statistics the shipped slider
    # directions are regressed on (pipeline/direction_finder.py), at the
    # cost of one [hair_dim x 6] head that lives only in the train state.
    lambda_geo: float = 0.0


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Top-level editing pipeline configuration."""
    sean: SEANConfig = dataclasses.field(default_factory=SEANConfig)
    bisenet: BiSeNetConfig = dataclasses.field(default_factory=BiSeNetConfig)
    color_texture: ColorTextureConfig = dataclasses.field(
        default_factory=ColorTextureConfig)
    shape: ShapeConfig = dataclasses.field(default_factory=ShapeConfig)
    rgb_predictor: PredictorConfig = dataclasses.field(
        default_factory=rgb_predictor_config)
    curliness_predictor: PredictorConfig = dataclasses.field(
        default_factory=curliness_predictor_config)
    edit_size: int = 256
    blending: bool = True
    poisson_iterations: int = 200
    # kept so the config matches the JAX one field for field: the port has
    # one blend path (ops/poisson_pallas, the masked-CG CUDA kernel on a
    # card), and HairEditor refuses False
    use_pallas_blend: bool = True
    compute_dtype: str = 'bfloat16'   # activation dtype; params stay float32
