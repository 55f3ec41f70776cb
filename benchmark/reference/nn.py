"""Functional float32 layers over a flat state dict.

Every layer reads its tensors from `p` by the name of the layer (the names
the program's modules give their parameters: `<layer>.weight`,
`<layer>.bias`), so one state dict drawn by the harness serves the
program and the reference alike.  `Numerics` says how the inputs of every
convolution and matrix product are held: as they are (the reference), or
rounded to float8 e4m3 with one scale a tensor (the control that
`correct` has to fail, a precision below the program's bfloat16).
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch
import torch.nn.functional as F

FP8_MAX = 448.0          # the largest finite float8 e4m3fn


class Numerics:
    """'float32' computes as it is; 'fp8' rounds each operand of a
    convolution or product to float8 e4m3 under a per-tensor scale that
    maps its largest magnitude to FP8_MAX, then computes in float32."""

    def __init__(self, kind: str = 'float32'):
        if kind not in ('float32', 'fp8'):
            raise ValueError(f'unknown numerics {kind!r}')
        self.kind = kind

    def q(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == 'float32':
            return x
        scale = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


FLOAT32 = Numerics('float32')


def sub(p: Mapping[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    """The entries of `p` under `prefix`, the prefix dropped."""
    return {k[len(prefix):]: v for k, v in p.items() if k.startswith(prefix)}


def conv(nx: Numerics, p, name: str, x, stride: int = 1, pad: int = 0,
         reflect: bool = False):
    w, b = p[f'{name}.weight'], p.get(f'{name}.bias')
    if reflect and pad:
        x, pad = F.pad(x, (pad,) * 4, mode='reflect'), 0
    return F.conv2d(nx.q(x), nx.q(w), b, stride, pad)


def conv_transpose(nx: Numerics, p, name: str, x, stride: int, pad: int,
                   out_pad: int):
    """Weights in torch's [in, out, kh, kw] layout."""
    w, b = p[f'{name}.weight'], p.get(f'{name}.bias')
    return F.conv_transpose2d(nx.q(x), nx.q(w), b, stride, pad, out_pad)


def dense(nx: Numerics, p, name: str, x):
    w, b = p[f'{name}.weight'], p.get(f'{name}.bias')
    return F.linear(nx.q(x), nx.q(w), b)


def lrelu(x):
    return F.leaky_relu(x, 0.2)


def instance_norm(x, eps: float = 1e-5):
    """Per sample and channel over H, W; biased variance."""
    var, mean = torch.var_mean(x, dim=(2, 3), keepdim=True, correction=0)
    return (x - mean) * torch.rsqrt(var + eps)


def batch_norm(x, running_mean=None, running_var=None, eps: float = 1e-5):
    """Parameter-free batch norm of NCHW: the batch's mean and biased
    variance (E[x^2] - E[x]^2, floored at 0) when no running statistics
    are given, else those."""
    if running_mean is None:
        mean = x.mean(dim=(0, 2, 3))
        var = torch.clamp_min((x * x).mean(dim=(0, 2, 3)) - mean * mean, 0.0)
    else:
        mean, var = running_mean, running_var
    return (x - mean.view(1, -1, 1, 1)) * torch.rsqrt(
        var.view(1, -1, 1, 1) + eps)


def sample_layer_norm(p, name: str, x, eps: float = 1e-5):
    """The shape branch's norm: over a whole sample, unbiased std,
    (x - mean) / (std + eps), then a per-channel gamma and beta."""
    n = x[0].numel()
    mean = x.mean(dim=(1, 2, 3), keepdim=True)
    var = ((x - mean) ** 2).sum(dim=(1, 2, 3), keepdim=True) / (n - 1)
    y = (x - mean) / (torch.sqrt(var) + eps)
    return y * p[f'{name}.gamma'].view(1, -1, 1, 1) \
        + p[f'{name}.beta'].view(1, -1, 1, 1)


def nearest(label: torch.Tensor, size: int) -> torch.Tensor:
    """Nearest resize of the trailing [H, W] of a label map: source index
    floor(i * H / size)."""
    h, w = label.shape[-2:]
    iy = torch.arange(size, device=label.device) * h // size
    ix = torch.arange(size, device=label.device) * w // size
    return label.index_select(-2, iy).index_select(-1, ix)


def one_hot(label: torch.Tensor, classes: int) -> torch.Tensor:
    """[N,H,W] labels -> [N,classes,H,W] float32; labels outside
    [0, classes) give an all-zero column."""
    ids = torch.arange(classes, device=label.device).view(1, -1, 1, 1)
    return (label.long()[:, None] == ids).to(torch.float32)


def upsample2x(x):
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
