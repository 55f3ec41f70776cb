# SEAN/pix2pix adversarial stack: the multiscale PatchGAN discriminator and
# the VGG19 feature extractor of the perceptual loss.
#
# Port of ctrlhair_tpu/models/sean_discriminator.py.  Feature maps are NCHW
# inside and out (the losses reduce them, so the layout never shows); the
# parameter names follow the flax modules, so convert.load_variables moves
# weights across both ways.  The VGG19 weights are random unless a
# torchvision vgg19().features state dict is converted (`convert_vgg19`):
# nothing is downloaded.

from __future__ import annotations

import functools
from typing import Any, Dict, List, Mapping

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ctrlhair_tpu_torch.models.layers import (
    InstanceNorm, TorchConv, leaky_relu)


class NLayerDiscriminator(nn.Module):
    """PatchGAN returning its intermediate features: C64-C128-C256-C512-1,
    4x4 kernels, pad 2, instance norm after the first layer."""

    def __init__(self, ndf: int = 64, n_layers: int = 4, input_nc: int = 22,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_layers = n_layers
        self.layer0 = TorchConv(input_nc, ndf, 4, 2, 2, dtype=dtype)
        nf = ndf
        for i in range(1, n_layers):
            nf_prev, nf = nf, min(nf * 2, 512)
            stride = 1 if i == n_layers - 1 else 2
            self.add_module(f'layer{i}', TorchConv(nf_prev, nf, 4, stride, 2,
                                                   dtype=dtype))
        self.out = TorchConv(nf, 1, 4, 1, 2, dtype=dtype)
        self.norm = InstanceNorm(dtype=dtype)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        h = leaky_relu(self.layer0(x))
        feats = [h]
        for i in range(1, self.n_layers):
            h = leaky_relu(self.norm(getattr(self, f'layer{i}')(h)))
            feats.append(h)
        feats.append(self.out(h))
        return feats


class MultiscaleDiscriminator(nn.Module):
    """`num_d` PatchGANs, each on the input average-pooled once more (3x3,
    stride 2, pad 1, the padding not counted)."""

    def __init__(self, num_d: int = 2, ndf: int = 64, n_layers: int = 4,
                 input_nc: int = 22, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_d = num_d
        for i in range(num_d):
            self.add_module(f'scale_{i}', NLayerDiscriminator(
                ndf, n_layers, input_nc, dtype=dtype))

    def forward(self, x: torch.Tensor) -> List[List[torch.Tensor]]:
        """x [N,C,H,W] -> per scale, the list of its features."""
        outs = []
        for i in range(self.num_d):
            outs.append(getattr(self, f'scale_{i}')(x))
            if i != self.num_d - 1:
                # contiguous first: CUDA's channels-last average pool with
                # padding returns a wrong input gradient (measured on the
                # H100 with torch 2.11: 0.88 of its scale, float64 too),
                # and the trainer's input, a concatenation of NHWC
                # permutes, is channels-last
                x = F.avg_pool2d(x.contiguous(), 3, 2, 1,
                                 count_include_pad=False)
        return outs


VGG19_CFG = [64, 64, 'M', 128, 128, 'M', 256, 256, 256, 256, 'M',
             512, 512, 512, 512, 'M', 512, 512, 512, 512]
# the slices end after these convs (torchvision feature indices 2 / 7 / 12
# / 21 / 30: relu1_1, relu2_1, relu3_1, relu4_1, relu5_1)
SLICE_AFTER_CONV = [1, 3, 5, 9, 13]


class VGG19Features(nn.Module):
    """VGG19's first 13 convs, returning the five perceptual-loss slices."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.plan = []                  # conv indices and 'M' pools, in order
        cin, conv_idx = 3, 0
        for v in VGG19_CFG:
            if conv_idx == SLICE_AFTER_CONV[-1]:
                break
            if v == 'M':
                self.plan.append('M')
                continue
            self.add_module(f'conv_{conv_idx}',
                            TorchConv(cin, v, 3, 1, 1, dtype=dtype))
            self.plan.append(conv_idx)
            cin, conv_idx = v, conv_idx + 1

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x [N,3,H,W] ImageNet-normalised -> the five slices."""
        slices = []
        for step in self.plan:
            if step == 'M':
                x = F.max_pool2d(x, 2, 2)
                continue
            x = F.relu(getattr(self, f'conv_{step}')(x))
            if step + 1 in SLICE_AFTER_CONV:
                slices.append(x)
        return slices


_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


@functools.lru_cache(maxsize=None)
@torch.inference_mode(False)
def _imagenet_stats(device: torch.device, dtype: torch.dtype):
    """(mean, std) on a device, made once (a CUDA graph captured over a
    training step cannot copy them from pageable host memory)."""
    return (torch.tensor(_IMAGENET_MEAN, dtype=dtype, device=device),
            torch.tensor(_IMAGENET_STD, dtype=dtype, device=device))


def vgg_preprocess(img_m11: torch.Tensor) -> torch.Tensor:
    """[-1,1] NHWC -> ImageNet-normalised NCHW input of VGG19Features."""
    mean, std = _imagenet_stats(img_m11.device, img_m11.dtype)
    return (((img_m11 + 1.0) / 2.0 - mean) / std).permute(0, 3, 1, 2)


def convert_vgg19(sd: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A torchvision vgg19().features state dict -> VGG19Features' state
    dict (torch's OIHW weights as they are; only the renaming differs)."""
    out = {}
    conv_idx = feat_idx = 0
    for v in VGG19_CFG:
        if conv_idx >= SLICE_AFTER_CONV[-1]:     # the model stops at relu5_1
            break
        if v == 'M':
            feat_idx += 1
            continue
        for leaf in ('weight', 'bias'):
            value = sd[f'{feat_idx}.{leaf}']
            out[f'conv_{conv_idx}.conv.{leaf}'] = torch.as_tensor(
                np.asarray(value.detach().cpu() if isinstance(
                    value, torch.Tensor) else value, np.float32))
        conv_idx += 1
        feat_idx += 2                            # conv + relu
    return out
