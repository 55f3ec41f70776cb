# Colour & texture branch: EigenGAN generator, the encoder-discriminator
# used as the texture/curliness encoder, the latent-prior discriminator and
# the predictors.
#
# Port of ctrlhair_tpu/models/color_texture.py.  All are small MLPs over the
# 512-d SEAN hair code and run in float32, as the editor and the trainers
# build them.  `train=True` is flax's train mode (BatchNorm on the batch's
# statistics, dropout in the predictors; models/layers.py).  flax infers
# each first layer's width from its input; here the SEAN code width is
# passed as `code_dim`.

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ctrlhair_tpu_torch.config import ColorTextureConfig, PredictorConfig
from ctrlhair_tpu_torch.models.layers import Dense, LinearBlock, MLP


class SubspaceLayer(nn.Module):
    """Orthogonal subspace projection (L * z) @ U + mu."""

    def __init__(self, dim: int, n_basis: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.U = nn.Parameter(torch.empty(n_basis, dim))
        self.L = nn.Parameter(torch.empty(n_basis))
        self.mu = nn.Parameter(torch.empty(dim))
        self.dtype = dtype

    def reset_parameters(self, gen: torch.Generator):
        n = self.L.shape[0]
        with torch.no_grad():
            nn.init.orthogonal_(self.U, generator=gen)
            self.L.copy_(torch.tensor([3.0 * i for i in range(n, 0, -1)]))
            self.mu.zero_()

    def forward(self, z):
        cd = self.dtype
        return (self.L.to(cd) * z) @ self.U.to(cd) + self.mu.to(cd)

    @staticmethod
    def orthogonal_regularizer(u: torch.Tensor) -> torch.Tensor:
        """mean((U U^T - I)^2)."""
        eye = torch.eye(u.shape[0], dtype=u.dtype, device=u.device)
        return torch.mean((u @ u.T - eye) ** 2)


class EigenGenerator(nn.Module):
    """Condition MLP with per-layer subspace noise injection."""

    def __init__(self, cfg: ColorTextureConfig,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.main_in = Dense(cfg.cond_dim, cfg.g_hidden_dim, dtype=dtype)
        for i in range(cfg.g_hidden_layer_num):
            self.add_module(f'subspace_{i}', SubspaceLayer(
                cfg.g_hidden_dim, cfg.subspace_dim, dtype=dtype))
            out_dim = (cfg.style_dim if i == cfg.g_hidden_layer_num - 1
                       else cfg.g_hidden_dim)
            self.add_module(f'main_mid_{i}', Dense(
                cfg.g_hidden_dim, out_dim, dtype=dtype))

    def forward(self, data: Mapping[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        noise = data['noise'].reshape(
            -1, cfg.g_hidden_layer_num, cfg.subspace_dim).to(self.dtype)
        x = torch.cat(_conds(cfg, data), dim=-1).to(self.dtype)
        x = self.main_in(x)
        for i in range(cfg.g_hidden_layer_num):
            x = x + getattr(self, f'subspace_{i}')(noise[:, i, :])
            x = getattr(self, f'main_mid_{i}')(F.leaky_relu(x, 0.2))
        return {'code': x}

    def orthogonal_loss(self) -> torch.Tensor:
        """Sum of the subspace layers' orthogonal regularisers."""
        return sum(SubspaceLayer.orthogonal_regularizer(
            getattr(self, f'subspace_{i}').U)
            for i in range(self.cfg.g_hidden_layer_num))


def _conds(cfg: ColorTextureConfig, data) -> list:
    conds = []
    if cfg.use_curliness:
        conds.append(data['noise_curliness'])
    if cfg.use_rgb_cond:
        conds.append(data['rgb_mean'])
    if cfg.use_pca_std_cond:
        conds.append(data['pca_std'])
    return conds


class MLPGenerator(nn.Module):
    """Plain MLP alternative generator."""

    def __init__(self, cfg: ColorTextureConfig,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        dims = [cfg.noise_dim + cfg.cond_dim] + \
            [cfg.g_hidden_dim] * cfg.g_hidden_layer_num
        for i in range(cfg.g_hidden_layer_num):
            self.add_module(f'layer_{i}', LinearBlock(
                dims[i], cfg.g_hidden_dim, cfg.g_norm, cfg.g_activ,
                dtype=dtype))
        self.head = LinearBlock(dims[-1], cfg.style_dim, 'none', 'none',
                                dtype=dtype)

    def forward(self, data):
        cfg = self.cfg
        x = torch.cat([data['noise']] + _conds(cfg, data),
                      dim=-1).to(self.dtype)
        for i in range(cfg.g_hidden_layer_num):
            x = getattr(self, f'layer_{i}')(x)
        return {'code': self.head(x)}


class CTDiscriminator(nn.Module):
    """Adversarial head + latent decoder over SEAN codes; the inference-time
    texture/curliness encoder."""

    def __init__(self, cfg: ColorTextureConfig,
                 code_dim: Optional[int] = None,
                 dtype: torch.dtype = torch.float32, train: bool = False):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.net = MLP(code_dim or cfg.style_dim, cfg.d_hidden_dim,
                       cfg.d_hidden_layer_num, self._out_dim(),
                       norm=cfg.d_norm, activation=cfg.d_activ, dtype=dtype,
                       train=train)

    def _out_dim(self) -> int:
        # The reference's head-width formula, quirks included: the rgb +3
        # is gated on the CURLINESS predictor, and the pca_std +1 is
        # ungated (with an external rgb predictor that unit is never read).
        cfg = self.cfg
        dim = 1 + cfg.noise_dim
        if cfg.use_rgb_cond and not cfg.external_curliness_predictor:
            dim += 3
        if cfg.use_pca_std_cond:
            dim += 1
        if cfg.use_curliness:
            dim += cfg.curliness_dim
            if not cfg.external_curliness_predictor:
                dim += 1
        return dim

    def forward(self, data):
        cfg = self.cfg
        out = self.net(data['code'].to(self.dtype))
        res = {'adv': out[:, :1]}
        ptr = 1
        res['noise'] = out[:, ptr:ptr + cfg.noise_dim]
        ptr += cfg.noise_dim
        if cfg.use_curliness:
            res['noise_curliness'] = out[:, ptr:ptr + cfg.curliness_dim]
            ptr += cfg.curliness_dim
            if not cfg.external_curliness_predictor:
                res['cls_curliness'] = out[:, ptr:ptr + 1]
                ptr += 1
        if cfg.use_rgb_cond and not cfg.external_rgb_predictor:
            res['rgb_mean'] = out[:, ptr:ptr + 3]
            ptr += 3
        if cfg.use_pca_std_cond and not cfg.external_rgb_predictor:
            res['pca_std'] = out[:, ptr:ptr + 1]
            ptr += 1
        return res


class CTDiscriminatorNoise(nn.Module):
    """Latent-prior discriminator on (noise, curliness)."""

    def __init__(self, cfg: ColorTextureConfig,
                 dtype: torch.dtype = torch.float32, train: bool = False):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        cin = cfg.noise_dim + (cfg.curliness_dim if cfg.use_curliness else 0)
        self.net = MLP(cin, cfg.d_hidden_dim, cfg.d_noise_hidden_layer_num,
                       1, norm=cfg.d_norm, activation=cfg.d_activ,
                       dtype=dtype, train=train)

    def forward(self, data):
        x = data['noise']
        if self.cfg.use_curliness:
            x = torch.cat([x, data['noise_curliness']], dim=-1)
        return {'adv': self.net(x.to(self.dtype))[:, :1]}


class Predictor(nn.Module):
    """Supervised readout of curliness / colour statistics (frozen behind
    the editor and the colour/texture trainer; trained by
    training/predictor_trainer.py with dropout in train mode)."""

    def __init__(self, cfg: PredictorConfig,
                 code_dim: Optional[int] = None,
                 dtype: torch.dtype = torch.float32, train: bool = False):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.net = MLP(code_dim or cfg.style_dim, cfg.hidden_dim,
                       cfg.hidden_layer_num, sum(cfg.predict_dict.values()),
                       norm=cfg.norm, activation=cfg.activ, dtype=dtype,
                       dropout=cfg.dropout, train=train)

    def forward(self, data, keep_masks: Optional[list] = None):
        """`keep_masks`: the dropout keep masks of a train-mode pass (see
        layers.MLP)."""
        out = self.net(data['code'].to(self.dtype), keep_masks)
        res, ptr = {}, 0
        for key, dim in self.cfg.predict_dict.items():
            res[key] = out[:, ptr:ptr + dim]
            ptr += dim
        return res


def make_generator(cfg: ColorTextureConfig, dtype=torch.float32):
    if cfg.gen_mode == 'eigengan':
        return EigenGenerator(cfg, dtype=dtype)
    return MLPGenerator(cfg, dtype=dtype)
