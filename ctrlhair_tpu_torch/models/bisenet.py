# BiSeNet face parser: ResNet-18 context path, attention refinement, feature
# fusion, 19-class head upsampled bilinearly with align_corners=True.
#
# Port of ctrlhair_tpu/models/bisenet.py.  NCHW inside; the public call
# takes and returns NHWC, as the JAX twin does.  `return_aux=True` builds
# the two auxiliary supervision heads of training (conv_out16 on the 1/8
# feature after conv_head16, conv_out32 on the 1/16 feature after
# conv_head32), upsampled bilinearly to the input as the main head is; the
# inference model builds neither, so its weights are the editor's.
# `train=True` puts every BatchNorm on batch statistics with flax's running
# update (models/layers.RunningBatchNorm; layers.set_train flips it).

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ctrlhair_tpu_torch.config import BiSeNetConfig
from ctrlhair_tpu_torch.models.layers import Conv, RunningBatchNorm, set_train
from ctrlhair_tpu_torch.ops.resize import resize_bilinear, resize_nearest


def _bn(features, dtype):
    return RunningBatchNorm(features, affine=True, dtype=dtype)


def _upsample(x: torch.Tensor, hw) -> torch.Tensor:
    return resize_bilinear(x.float(), hw, align_corners=True).permute(
        0, 2, 3, 1)


class ConvBNReLU(nn.Module):
    def __init__(self, cin: int, features: int, kernel: int = 3,
                 stride: int = 1, pad: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv(cin, features, kernel, stride, pad, bias=False,
                         dtype=dtype)
        self.bn = _bn(features, dtype)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class BasicBlock(nn.Module):
    def __init__(self, cin: int, features: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cbr1 = ConvBNReLU(cin, features, 3, stride, 1, dtype=dtype)
        self.conv2 = Conv(features, features, 3, 1, 1, bias=False,
                          dtype=dtype)
        self.bn2 = _bn(features, dtype)
        self.has_down = cin != features or stride != 1
        if self.has_down:
            self.down_conv = Conv(cin, features, 1, stride, 0, bias=False,
                                  dtype=dtype)
            self.down_bn = _bn(features, dtype)

    def forward(self, x):
        residual = self.bn2(self.conv2(self.cbr1(x)))
        shortcut = self.down_bn(self.down_conv(x)) if self.has_down else x
        return F.relu(shortcut + residual)


class ResNet18(nn.Module):
    """Backbone returning the 1/8, 1/16 and 1/32 features."""

    def __init__(self, blocks_per_stage: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv(3, 64, 7, 2, 3, bias=False, dtype=dtype)
        self.bn1 = _bn(64, dtype)
        self.blocks_per_stage = blocks_per_stage
        cin = 64
        for i, (feats, stride) in enumerate(
                [(64, 1), (128, 2), (256, 2), (512, 2)]):
            for j in range(blocks_per_stage):
                self.add_module(f'layer{i + 1}_{j}', BasicBlock(
                    cin, feats, stride if j == 0 else 1, dtype=dtype))
                cin = feats

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        # max_pool2d pads with -inf, as the JAX twin's explicit -inf pad
        x = F.max_pool2d(x, 3, 2, padding=1)
        feats = []
        for i in range(4):
            for j in range(self.blocks_per_stage):
                x = getattr(self, f'layer{i + 1}_{j}')(x)
            feats.append(x)
        return feats[1], feats[2], feats[3]


class AttentionRefinement(nn.Module):
    def __init__(self, cin: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = ConvBNReLU(cin, features, 3, 1, 1, dtype=dtype)
        self.conv_atten = Conv(features, features, 1, bias=False, dtype=dtype)
        self.bn_atten = _bn(features, dtype)

    def forward(self, x):
        feat = self.conv(x)
        atten = feat.mean(dim=(2, 3), keepdim=True)
        atten = self.bn_atten(self.conv_atten(atten))
        return feat * torch.sigmoid(atten)


class FeatureFusion(nn.Module):
    def __init__(self, cin: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.convblk = ConvBNReLU(cin, features, 1, 1, 0, dtype=dtype)
        self.conv1 = Conv(features, features // 4, 1, bias=False, dtype=dtype)
        self.conv2 = Conv(features // 4, features, 1, bias=False, dtype=dtype)

    def forward(self, fsp, fcp):
        feat = self.convblk(torch.cat([fsp, fcp], dim=1))
        atten = feat.mean(dim=(2, 3), keepdim=True)
        atten = torch.sigmoid(self.conv2(F.relu(self.conv1(atten))))
        return feat * atten + feat


class BiSeNetOutput(nn.Module):
    def __init__(self, cin: int, mid: int, n_classes: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = ConvBNReLU(cin, mid, 3, 1, 1, dtype=dtype)
        self.conv_out = Conv(mid, n_classes, 1, bias=False, dtype=dtype)

    def forward(self, x):
        return self.conv_out(self.conv(x))


class BiSeNet(nn.Module):
    def __init__(self, cfg: BiSeNetConfig, dtype: torch.dtype = torch.float32,
                 train: bool = False, return_aux: bool = False):
        super().__init__()
        self.return_aux = return_aux
        self.resnet = ResNet18(cfg.blocks_per_stage, dtype=dtype)
        self.conv_avg = ConvBNReLU(512, 128, 1, 1, 0, dtype=dtype)
        self.arm32 = AttentionRefinement(512, 128, dtype=dtype)
        self.conv_head32 = ConvBNReLU(128, 128, 3, 1, 1, dtype=dtype)
        self.arm16 = AttentionRefinement(256, 128, dtype=dtype)
        self.conv_head16 = ConvBNReLU(128, 128, 3, 1, 1, dtype=dtype)
        self.ffm = FeatureFusion(256, 256, dtype=dtype)
        self.conv_out = BiSeNetOutput(256, 256, cfg.n_classes, dtype=dtype)
        if return_aux:
            self.conv_out16 = BiSeNetOutput(128, 64, cfg.n_classes,
                                            dtype=dtype)
            self.conv_out32 = BiSeNetOutput(128, 64, cfg.n_classes,
                                            dtype=dtype)
        set_train(self, train)

    def forward(self, x: torch.Tensor):
        """x [N,H,W,3] ImageNet-normalised -> [N,H,W,n_classes] float32
        main-head logits, or (main, aux16, aux32) with return_aux."""
        h, w = x.shape[1:3]
        feat8, feat16, feat32 = self.resnet(x.permute(0, 3, 1, 2))
        avg = self.conv_avg(feat32.mean(dim=(2, 3), keepdim=True))
        f32 = self.arm32(feat32) + avg            # broadcast over H, W
        f32_up = self.conv_head32(resize_nearest(f32, feat16.shape[2:]))
        f16 = self.arm16(feat16) + f32_up
        f16_up = self.conv_head16(resize_nearest(f16, feat8.shape[2:]))
        fuse = self.ffm(feat8, f16_up)
        out = _upsample(self.conv_out(fuse), (h, w))
        if self.return_aux:
            return (out, _upsample(self.conv_out16(f16_up), (h, w)),
                    _upsample(self.conv_out32(f32_up), (h, w)))
        return out


IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_imagenet(img01: torch.Tensor) -> torch.Tensor:
    """[0,1] float RGB [..., 3] -> ImageNet-normalised."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32,
                        device=img01.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=img01.device)
    return (img01 - mean) / std
