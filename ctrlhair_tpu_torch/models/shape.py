# Shape branch: the hair-mask VAE (encoders and decoders).
#
# Port of ctrlhair_tpu/models/shape.py, with the two discriminators of the
# shape trainer (ShapeDiscriminator, a MaskEncoder under the flax name
# `dis`; ShapeDiscriminatorNoise, an MLP under `net`).  Convs run NCHW; the
# flatten before each encoder head and the reshape after each decoder's
# input layer use the JAX package's NHWC order, so dense weights carry
# across unchanged.  Public masks are NHWC: hair [N,H,W,1], face
# [N,H,W,18], decode [N,H,W,19].  Train mode changes nothing in these
# models: the generator's norm ('ln', SampleLayerNorm) keeps no statistics
# and the discriminators have none ('none'), so the JAX modules'
# `train=True` has no counterpart here.  The VAE's sampling takes its
# noise from the caller (training/shape_trainer.py); `encode_hair` returns
# the mean as the sample, as the JAX twin does without an rng.

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn

from ctrlhair_tpu_torch.config import ShapeConfig
from ctrlhair_tpu_torch.constants import HAIR_IDX
from ctrlhair_tpu_torch.models.layers import MLP, ConvBlock, LinearBlock
from ctrlhair_tpu_torch.ops.resize import upsample2x_nearest


def fourier_pos_encoding(img_size: int, order: int = 10) -> np.ndarray:
    """[H, W, 4*order] sin/cos positional grid: the sin block then the cos
    block, each (order, 2[meshgrid xy]) flattened row-major."""
    coords = np.linspace(0, 1, img_size, endpoint=False)
    xx, yy = np.meshgrid(coords, coords)          # both [H, W]
    bi = np.stack([xx, yy], 0)[None]              # [1, 2, H, W]
    freqs = (2.0 ** np.arange(order)) * math.pi   # [order]
    freqs = freqs[:, None, None, None]
    gamma = np.concatenate([np.sin(freqs * bi), np.cos(freqs * bi)], 0)
    gamma = gamma.reshape(-1, img_size, img_size)  # [4*order, H, W]
    return np.transpose(gamma, (1, 2, 0)).astype(np.float32)


class MaskEncoder(nn.Module):
    """Strided conv encoder over (mask ++ positional encoding) channels."""

    def __init__(self, cfg: ShapeConfig, in_channels: int, out_dim: int,
                 norm: str, vae: bool = False, hidden_in_channel: int = 32,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.vae = vae
        self.dtype = dtype
        ch = in_channels + 4 * cfg.pos_encoding_order
        for i in range(cfg.layer_num):
            out = min(cfg.max_channel, 2 ** i * hidden_in_channel)
            self.add_module(f'down_{i}', ConvBlock(
                ch, out, 4, 2, 1, norm=norm, activation='lrelu', dtype=dtype))
            ch = out
        flat = ch * (cfg.img_size // 2 ** cfg.layer_num) ** 2
        self.out = LinearBlock(flat, out_dim, 'none', 'none', dtype=dtype)
        if vae:
            self.std_out = LinearBlock(flat, out_dim, 'none', 'none',
                                       dtype=dtype)
        pos = fourier_pos_encoding(cfg.img_size, cfg.pos_encoding_order)
        self.register_buffer('pos', torch.tensor(pos).permute(2, 0, 1),
                             persistent=False)

    def forward(self, mask: torch.Tensor):
        """mask [N,H,W,C] -> (mean, std or None)."""
        n = mask.shape[0]
        pos = self.pos.to(self.dtype).expand(n, -1, -1, -1)
        x = torch.cat([mask.permute(0, 3, 1, 2).to(self.dtype), pos], dim=1)
        for i in range(self.cfg.layer_num):
            x = getattr(self, f'down_{i}')(x)
        x = x.permute(0, 2, 3, 1).reshape(n, -1)       # NHWC flatten order
        mean = self.out(x)
        if self.vae:
            return mean, torch.abs(self.std_out(x))
        return mean, None


class MaskDecoder(nn.Module):
    """Linear -> reshape -> (nearest 2x up + conv) stack."""

    def __init__(self, cfg: ShapeConfig, in_dim: int, out_channels: int,
                 norm: str, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.in_ch = min(32 * 2 ** cfg.layer_num, cfg.max_channel)
        self.s = cfg.img_size // (2 ** cfg.layer_num)
        self.in_layer = LinearBlock(in_dim, self.in_ch * self.s * self.s,
                                    'none', 'none', dtype=dtype)
        ch = self.in_ch
        for i in range(cfg.layer_num):
            out = min(32 * 2 ** (cfg.layer_num - 1 - i), cfg.max_channel)
            self.add_module(f'up_{i}', ConvBlock(
                ch, out, 3, 1, 1, norm=norm, activation='lrelu', dtype=dtype))
            ch = out
        self.out = ConvBlock(ch, out_channels, 3, 1, 1, norm='none',
                             activation='none', dtype=dtype)

    def forward(self, code: torch.Tensor) -> torch.Tensor:
        """code [N,in_dim] -> logits NCHW."""
        x = self.in_layer(code)
        x = x.reshape(-1, self.s, self.s, self.in_ch).permute(0, 3, 1, 2)
        for i in range(self.cfg.layer_num):
            x = getattr(self, f'up_{i}')(upsample2x_nearest(x))
        return self.out(x)


class ShapeGenerator(nn.Module):
    """Hair VAE encoder + face encoder + paired decoders."""

    def __init__(self, cfg: ShapeConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.hair_encoder = MaskEncoder(
            cfg, 1, cfg.hair_dim, cfg.g_norm, vae=cfg.vae_hair_mode,
            hidden_in_channel=cfg.hidden_in_channel, dtype=dtype)
        self.face_encoder = MaskEncoder(
            cfg, 18, cfg.face_dim, cfg.g_norm, vae=False,
            hidden_in_channel=cfg.hidden_in_channel, dtype=dtype)
        self.hair_decoder = MaskDecoder(cfg, cfg.face_dim + cfg.hair_dim, 1,
                                        cfg.g_norm, dtype=dtype)
        self.face_decoder = MaskDecoder(cfg, cfg.face_dim, 18, cfg.g_norm,
                                        dtype=dtype)

    def encode_hair(self, hair: torch.Tensor):
        """hair [N,H,W,1] -> (sample, mean, std); without a sampling rng the
        sample is the mean."""
        mean, std = self.hair_encoder(hair)
        return mean, mean, std

    def encode_face(self, face: torch.Tensor) -> torch.Tensor:
        return self.face_encoder(face)[0]

    def decode_hair_logit(self, hair_code: torch.Tensor,
                          face_code: torch.Tensor) -> torch.Tensor:
        """-> hair_logit [N,H,W,1] (the hair half of decode_logits)."""
        return self.hair_decoder(torch.cat([face_code, hair_code], -1)
                                 ).permute(0, 2, 3, 1)

    def decode_logits(self, hair_code: torch.Tensor,
                      face_code: torch.Tensor):
        """-> (hair_logit [N,H,W,1], face_logit [N,H,W,18])."""
        face_logit = self.face_decoder(face_code)
        return (self.decode_hair_logit(hair_code, face_code),
                face_logit.permute(0, 2, 3, 1))

    def merge_logits(self, hair_logit: torch.Tensor,
                     face_logit: torch.Tensor) -> torch.Tensor:
        logit = torch.cat([face_logit[..., :HAIR_IDX], hair_logit,
                           face_logit[..., HAIR_IDX:]], dim=-1)
        return torch.softmax(logit, dim=-1)

    def decode(self, hair_code: torch.Tensor,
               face_code: torch.Tensor) -> torch.Tensor:
        """codes -> [N,H,W,19] soft mask."""
        return self.merge_logits(*self.decode_logits(hair_code, face_code))


class ShapeDiscriminator(nn.Module):
    """19-channel mask [N,H,W,19] -> one logit [N,1]."""

    def __init__(self, cfg: ShapeConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dis = MaskEncoder(cfg, 19, 1, cfg.d_norm, vae=False,
                               hidden_in_channel=cfg.d_hidden_in_channel,
                               dtype=dtype)

    def forward(self, mask: torch.Tensor) -> torch.Tensor:
        return self.dis(mask)[0]


class ShapeDiscriminatorNoise(nn.Module):
    """The latent-prior discriminator on hair codes [N,hair_dim] -> [N,1]."""

    def __init__(self, cfg: ShapeConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.net = MLP(cfg.hair_dim, cfg.d_hidden_dim,
                       cfg.d_noise_hidden_layer_num, 1, norm='none',
                       activation='lrelu', dtype=dtype)

    def forward(self, code: torch.Tensor) -> torch.Tensor:
        return self.net(code)
