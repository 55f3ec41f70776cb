# SEAN: the Zencoder style encoder and the ACE/SPADE generator.
#
# Port of ctrlhair_tpu/models/sean.py.  Inside, feature maps are NCHW; the public
# entry points keep the JAX layouts: images [N,H,W,3], labels [N,H,W],
# codes [N,19,D].
#   * encode = Zencoder + one masked-mean region pool (a batched matmul),
#   * decode = SPADE/ACE generator; the 19 per-region fc_mu linears are one
#     stacked [19,D,D] einsum, and the style convs conv(one_hot (x) mu) are
#     folded through the 19 region vectors (exact by linearity): a grouped
#     conv of the 19-channel one-hot with per-sample kernels K @ mu.
# Train mode (layers.set_train, as the SEAN trainer sets it): the
# 'syncbatch' parameter-free norm takes the batch's statistics and updates
# its running ones by flax's rule; ACE noise, with cfg.use_ace_noise, is an
# argument, {'<block>.<ace>': [N,1,H,W]} (shapes and JAX's key order in
# `ace_noise_shapes`), each times the ACE's noise_var; cfg.remat_blocks
# recomputes each block in the backward (torch.utils.checkpoint, as
# nn.remat), whose second pass through the norms updates their running
# statistics again: the trainer keeps those of the forward.

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ctrlhair_tpu_torch.config import SEANConfig
from ctrlhair_tpu_torch.models.layers import (
    Dense, InstanceNorm, RunningBatchNorm, TorchConv, TorchConvTranspose,
    leaky_relu)
from ctrlhair_tpu_torch.ops.resize import (
    downsample_label_pyramid, resize_nearest, upsample2x_nearest)
from ctrlhair_tpu_torch.utils.masks import label_to_one_hot


def _one_hot_nchw(label: torch.Tensor, num_classes: int,
                  dtype: torch.dtype) -> torch.Tensor:
    return label_to_one_hot(label, num_classes, dtype).permute(0, 3, 1, 2)


class Zencoder(nn.Module):
    """Image -> dense style map: conv3(reflect) -> IN -> lrelu; two
    stride-2 downsamples; one transposed upsample; conv to style_dim, tanh.
    A 256 px input gives a 128x128 map."""

    def __init__(self, cfg: SEANConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        ngf = cfg.zencoder_ngf
        self.dtype = dtype
        self.stem = TorchConv(3, ngf, 3, 1, 1, pad_type='reflect',
                              dtype=dtype)
        self.down_0 = TorchConv(ngf, ngf * 2, 3, 2, 1, dtype=dtype)
        self.down_1 = TorchConv(ngf * 2, ngf * 4, 3, 2, 1, dtype=dtype)
        self.up_0 = TorchConvTranspose(ngf * 4, ngf * 8, 3, 2, 1, 1,
                                       dtype=dtype)
        self.out = TorchConv(ngf * 8, cfg.style_dim, 3, 1, 1,
                             pad_type='reflect', dtype=dtype)
        self.norm = InstanceNorm(dtype=dtype)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        """img [N,3,H,W] -> [N,D,H/2,W/2] in the compute dtype."""
        x = img.to(self.dtype)
        for conv in (self.stem, self.down_0, self.down_1, self.up_0):
            x = leaky_relu(self.norm(conv(x)))
        return torch.tanh(self.out(x))


def region_style_pool(code_map: torch.Tensor, seg_onehot: torch.Tensor
                      ) -> torch.Tensor:
    """Masked mean-pool of a style map into per-region codes.

    code_map: [N,H,W,D]; seg_onehot: [N,H,W,R] (NCHW tensors pass as
    permuted views).  Returns [N,R,D] float32; regions with zero area give
    all-zero codes.
    """
    code_map = code_map.float()
    seg = seg_onehot.to(code_map.dtype)
    summed = torch.einsum('nhwr,nhwd->nrd', seg, code_map)
    area = seg.sum(dim=(1, 2))[..., None]
    return torch.where(area > 0, summed / area.clamp(min=1.0),
                       torch.zeros_like(summed))


class SPADE(nn.Module):
    """Plain SPADE gamma/beta head over the one-hot label."""

    def __init__(self, label_nc: int, norm_nc: int, hidden: int = 128,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.mlp_shared = TorchConv(label_nc, hidden, 3, 1, 1, dtype=dtype)
        self.mlp_gamma = TorchConv(hidden, norm_nc, 3, 1, 1, dtype=dtype)
        self.mlp_beta = TorchConv(hidden, norm_nc, 3, 1, 1, dtype=dtype)

    def forward(self, seg):
        h = F.relu(self.mlp_shared(seg))
        return self.mlp_gamma(h), self.mlp_beta(h)


class ACE(nn.Module):
    """Region-adaptive (de)normalisation: learned noise (train mode, when
    given), parameter-free norm (running statistics at inference, the
    batch's in train mode), SPADE modulation blended with per-region style
    modulation."""

    def __init__(self, cfg: SEANConfig, norm_nc: int, use_styles: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c, d, r = norm_nc, cfg.style_dim, cfg.semantic_nc
        self.cfg = cfg
        self.use_styles = use_styles
        self.dtype = dtype
        # learned noise scale, applied only to the noise of train mode
        self.noise_var = nn.Parameter(torch.zeros(c))
        if cfg.param_free_norm == 'instance':
            self.pfn = InstanceNorm(dtype=dtype)
        else:
            self.pfn = RunningBatchNorm(c, affine=False, dtype=dtype)
        self.spade = SPADE(r, c, cfg.spade_hidden, dtype=dtype)
        if use_styles:
            self.fc_mu_kernel = nn.Parameter(torch.empty(r, d, d))
            self.fc_mu_bias = nn.Parameter(torch.zeros(r, d))
            self.conv_gamma = TorchConv(d, c, 3, 1, 1, dtype=dtype)
            self.conv_beta = TorchConv(d, c, 3, 1, 1, dtype=dtype)
            self.blending_gamma = nn.Parameter(torch.zeros(1))
            self.blending_beta = nn.Parameter(torch.zeros(1))

    def reset_parameters(self, gen: torch.Generator):
        with torch.no_grad():
            self.noise_var.zero_()
            if self.use_styles:
                r, d, _ = self.fc_mu_kernel.shape
                # variance_scaling(1/3, fan_in, uniform) on [r, d, d]:
                # flax counts fan_in = d * r for a stacked kernel
                bound = 1.0 / math.sqrt(d * r)
                self.fc_mu_kernel.uniform_(-bound, bound, generator=gen)
                self.fc_mu_bias.zero_()
                self.blending_gamma.zero_()
                self.blending_beta.zero_()

    def forward(self, x: torch.Tensor, seg: torch.Tensor,
                style_codes: Optional[torch.Tensor],
                noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [N,C,H,W]; seg one-hot [N,R,H,W]; style_codes [N,R,D];
        noise [N,1,H,W] (train mode with cfg.use_ace_noise)."""
        cd = self.dtype
        if self.cfg.use_ace_noise and noise is not None:
            x = x + noise.to(cd) * self.noise_var.to(cd).view(1, -1, 1, 1)
        normalized = self.pfn(x)
        gamma_spade, beta_spade = self.spade(seg)
        if not self.use_styles:
            return normalized * (1 + gamma_spade) + beta_spade
        # all 19 fc_mu linears as one einsum: [R,D,D] x [N,R,D]
        mu = torch.einsum('rio,nri->nro', self.fc_mu_kernel.to(cd),
                          style_codes.to(cd)) + self.fc_mu_bias.to(cd)
        mu = F.relu(mu)
        if self.cfg.fold_style_convs:
            gamma_avg = self._folded_style_conv(self.conv_gamma, seg, mu)
            beta_avg = self._folded_style_conv(self.conv_beta, seg, mu)
        else:
            middle_avg = torch.einsum('nrhw,nrd->ndhw', seg, mu)
            gamma_avg = self.conv_gamma(middle_avg)
            beta_avg = self.conv_beta(middle_avg)
        ga = torch.sigmoid(self.blending_gamma).to(cd)
        ba = torch.sigmoid(self.blending_beta).to(cd)
        gamma = ga * gamma_avg + (1 - ga) * gamma_spade
        beta = ba * beta_avg + (1 - ba) * beta_spade
        return normalized * (1 + gamma) + beta

    def _folded_style_conv(self, conv: TorchConv, seg: torch.Tensor,
                           mu: torch.Tensor) -> torch.Tensor:
        """conv(seg (x) mu) without the dense D-channel map: the map is
        constant per region, so the 3x3 kernel folds through the region
        vectors into a per-sample [C,R,3,3] kernel applied to the one-hot."""
        cd = self.dtype
        n, r, h, w = seg.shape
        weight = conv.conv.weight.to(cd)                   # [C,D,3,3]
        c = weight.shape[0]
        folded = torch.einsum('cdyx,nrd->ncryx', weight, mu)
        x = seg.to(cd).reshape(1, n * r, h, w)
        if h * w == 1:
            # on 1x1 maps the reshape is a view whose strides read as
            # channels-last, and the CPU's float64 convolution (slow_conv2d)
            # then refuses its own weight gradient; larger maps are copied
            # by the reshape
            x = x.clone(memory_format=torch.contiguous_format)
        out = F.conv2d(x, folded.reshape(n * c, r, 3, 3), padding=1,
                       groups=n)
        return out.reshape(n, c, h, w) + conv.conv.bias.to(cd).view(1, c,
                                                                      1, 1)


class SPADEResnetBlock(nn.Module):
    """ACE -> lrelu -> conv, twice, with a learned shortcut when the width
    changes."""

    def __init__(self, cfg: SEANConfig, fin: int, fout: int,
                 use_styles: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        fmiddle = min(fin, fout)
        self.learned_shortcut = fin != fout
        self.ace_0 = ACE(cfg, fin, use_styles, dtype=dtype)
        self.conv_0 = TorchConv(fin, fmiddle, 3, 1, 1, dtype=dtype)
        self.ace_1 = ACE(cfg, fmiddle, use_styles, dtype=dtype)
        self.conv_1 = TorchConv(fmiddle, fout, 3, 1, 1, dtype=dtype)
        if self.learned_shortcut:
            self.ace_s = ACE(cfg, fin, use_styles, dtype=dtype)
            self.conv_s = TorchConv(fin, fout, 1, 1, 0, use_bias=False,
                                    dtype=dtype)

    def forward(self, x, seg, style_codes,
                noise: Optional[Dict[str, torch.Tensor]] = None):
        """`noise`: {'ace_0', 'ace_1'[, 'ace_s']: [N,1,H,W]} or None."""
        noise = noise or {}
        dx = self.conv_0(leaky_relu(self.ace_0(
            x, seg, style_codes, noise.get('ace_0'))))
        dx = self.conv_1(leaky_relu(self.ace_1(
            dx, seg, style_codes, noise.get('ace_1'))))
        xs = x
        if self.learned_shortcut:
            xs = self.conv_s(self.ace_s(x, seg, style_codes,
                                        noise.get('ace_s')))
        return xs + dx


class SEANGenerator(nn.Module):
    """SPADE generator with SEAN blocks: one one-hot map per internal
    resolution plus [N,19,D] codes -> NCHW image in [-1,1], float32."""

    def __init__(self, cfg: SEANConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        nf = cfg.ngf
        self.cfg = cfg
        self.dtype = dtype
        r = cfg.semantic_nc
        self.fc = TorchConv(r, 16 * nf, 3, 1, 1, dtype=dtype)
        self.head_0 = SPADEResnetBlock(cfg, 16 * nf, 16 * nf, dtype=dtype)
        for m in range(cfg.num_middle_blocks):
            self.add_module(f'G_middle_{m}', SPADEResnetBlock(
                cfg, 16 * nf, 16 * nf, dtype=dtype))
        # default num_up_layers=5: 4 up blocks 16nf->8nf->4nf->2nf->nf, the
        # last without styles
        n_up = cfg.num_up_layers - 1
        self.chans = [16 * nf] + [nf * 2 ** (n_up - 1 - i)
                                  for i in range(n_up)]
        for i in range(n_up):
            self.add_module(f'up_{i}', SPADEResnetBlock(
                cfg, self.chans[i], self.chans[i + 1],
                use_styles=(i < n_up - 1), dtype=dtype))
        self.conv_img = TorchConv(self.chans[-1], 3, 3, 1, 1, dtype=dtype)

    def block_names(self):
        """(block name, index of its one-hot map) in forward order."""
        return ([('head_0', 0)]
                + [(f'G_middle_{m}', 1)
                   for m in range(self.cfg.num_middle_blocks)]
                + [(f'up_{i}', 2 + i) for i in range(len(self.chans) - 1)])

    def forward(self, seg_pyramid: Sequence[torch.Tensor],
                style_codes: torch.Tensor,
                noise: Optional[Dict[str, torch.Tensor]] = None
                ) -> torch.Tensor:
        """`noise` as in ace_noise_shapes; with cfg.remat_blocks, a pass
        that records gradients recomputes each block in the backward."""
        segs = [s.to(self.dtype) for s in seg_pyramid]
        x = self.fc(segs[0])
        remat = self.cfg.remat_blocks and torch.is_grad_enabled()
        for name, level in self.block_names():
            if name.startswith('up_'):
                x = upsample2x_nearest(x)
            block = getattr(self, name)
            sub = None
            if noise is not None:
                sub = {k.split('.', 1)[1]: v for k, v in noise.items()
                       if k.split('.', 1)[0] == name}
            if remat:
                x = checkpoint(block, x, segs[level], style_codes, sub,
                               use_reentrant=False)
            else:
                x = block(x, segs[level], style_codes, sub)
            if name == 'head_0':
                x = upsample2x_nearest(x)
        x = self.conv_img(leaky_relu(x))
        return torch.tanh(x).float()


class ConvEncoder(nn.Module):
    """Image -> (mu, logvar), SEAN's VAE encoder: six stride-2 convs
    (ngf, 2ngf, 4ngf, 8ngf, 8ngf, 8ngf) each with InstanceNorm and leaky
    ReLU, flattened in flax's [N,H,W,C] order, then two Dense heads.
    Unused by the editor and the trainers, as in the JAX package; its
    parameters take flax's layout (layer{i}.conv, fc_mu, fc_var), so
    convert carries them.  flax sizes the heads from the first input; here
    they are sized for `img_size` (default cfg.crop_size)."""

    def __init__(self, cfg: SEANConfig, latent_dim: int = 256,
                 img_size: Optional[int] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        ndf = cfg.ngf
        chans = [ndf, ndf * 2, ndf * 4, ndf * 8, ndf * 8, ndf * 8]
        size = cfg.crop_size if img_size is None else img_size
        cin = 3
        for i, c in enumerate(chans):
            self.add_module(f'layer{i}', TorchConv(cin, c, 3, 2, 1,
                                                   dtype=dtype))
            cin, size = c, (size - 1) // 2 + 1
        self.norm = InstanceNorm(dtype=dtype)
        self.n_layers = len(chans)
        self.fc_mu = Dense(cin * size * size, latent_dim, dtype=dtype)
        self.fc_var = Dense(cin * size * size, latent_dim, dtype=dtype)

    def forward(self, img: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """img [N,H,W,3] -> (mu, logvar) [N, latent_dim]."""
        x = img.permute(0, 3, 1, 2)
        for i in range(self.n_layers):
            x = leaky_relu(self.norm(getattr(self, f'layer{i}')(x)))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return self.fc_mu(x), self.fc_var(x)


class SEAN(nn.Module):
    """Zencoder + generator with the two public entry points."""

    def __init__(self, cfg: SEANConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.zencoder = Zencoder(cfg, dtype=dtype)
        self.generator = SEANGenerator(cfg, dtype=dtype)

    def pyramid_sizes(self) -> Tuple[int, ...]:
        s = self.cfg.start_size
        return tuple(s * 2 ** i for i in range(self.cfg.num_up_layers + 1))

    def encode(self, img: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
        """img [N,H,W,3] in [-1,1]; label [N,H,W] int -> [N,19,D] float32."""
        # pool in float32: style codes are the precision-sensitive interface
        code_map = self.zencoder(img.permute(0, 3, 1, 2)).float()
        small = resize_nearest(label, code_map.shape[2:])
        seg = label_to_one_hot(small, self.cfg.semantic_nc)
        return region_style_pool(code_map.permute(0, 2, 3, 1), seg)

    def decode(self, label: torch.Tensor, style_codes: torch.Tensor,
               noise: Optional[Dict[str, torch.Tensor]] = None
               ) -> torch.Tensor:
        """label [N,H,W] int + codes [N,19,D] -> image [N,H,W,3] in [-1,1];
        noise as in SEANGenerator.forward."""
        labels = downsample_label_pyramid(label, self.pyramid_sizes())
        segs = [_one_hot_nchw(lb, self.cfg.semantic_nc, torch.float32)
                for lb in labels]
        return self.generator(segs, style_codes, noise).permute(0, 2, 3, 1)

    def forward(self, img: torch.Tensor, label: torch.Tensor,
                noise: Optional[Dict[str, torch.Tensor]] = None
                ) -> torch.Tensor:
        """Encode `img` under `label`, decode the codes: the trainer's
        reconstruction."""
        return self.decode(label, self.encode(img, label), noise)


def ace_noise_shapes(cfg: SEANConfig, n: int) -> Dict[str, Tuple[int, ...]]:
    """{'<block>.<ace>': [n,1,H,W]} for every ACE of the generator, in the
    order JAX draws their noise: the generator splits its key once per block
    (head_0, G_middle_*, up_*), a block once per ACE (ace_0, ace_1, then
    ace_s where the width changes), and each ACE draws normal noise of its
    input's [N,H,W,1] from its key."""
    nf = cfg.ngf
    n_up = cfg.num_up_layers - 1
    chans = [16 * nf] + [nf * 2 ** (n_up - 1 - i) for i in range(n_up)]
    s = cfg.start_size
    blocks = ([('head_0', 16 * nf, 16 * nf, s)]
              + [(f'G_middle_{m}', 16 * nf, 16 * nf, 2 * s)
                 for m in range(cfg.num_middle_blocks)]
              + [(f'up_{i}', chans[i], chans[i + 1], 4 * s * 2 ** i)
                 for i in range(n_up)])
    out = {}
    for name, fin, fout, size in blocks:
        aces = ['ace_0', 'ace_1'] + (['ace_s'] if fin != fout else [])
        for ace in aces:
            out[f'{name}.{ace}'] = (n, 1, size, size)
    return out
