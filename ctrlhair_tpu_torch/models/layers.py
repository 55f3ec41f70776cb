# Neural building blocks (torch.nn, NCHW inside).
#
# Port of ctrlhair_tpu/models/layers.py.  Every module that owns weights is
# named after its flax counterpart, so a flax parameter path maps onto a
# torch attribute path (see convert.py).  Activations run in the module's
# compute dtype (bfloat16 by default at inference): inputs, weights and
# biases are cast to it at each layer, as flax does, while parameters stay
# float32.  The normalisations compute their statistics in float32.
#
# Train mode, as flax's `train=True`, is a constructor flag (`train_mode`;
# `set_train` flips it): BatchNorm then normalises with the batch's
# statistics and updates its running ones by flax's rule, and LinearBlock
# applies dropout.  torch's own training flag is left alone, so eval() and
# train() change nothing here.  Spectral normalisation is functional, as in
# JAX (`spectral_normalize_tree`): the trainer keeps the power-iteration
# vectors as state and runs a model under the normalised weights
# (`replaced_parameters`).
# The norms compute their statistics in float32, or in float64 for float64
# activations (flax's promote_types(dtype, float32));
# `set_compute_dtype` switches a built model's activations to another
# dtype, as building it with `dtype=` does.  Under data parallelism
# (`set_sync`, flax's BatchNorm(axis_name='dp')) a train-mode BatchNorm
# takes the statistics of the global batch.  Under tensor parallelism
# (`set_tp`, the placement of JAX's shard_params) a Conv, ConvTranspose or
# Dense whose kernel JAX shards over 'tp' holds this rank's slice of the
# output features and runs column-parallel: y = tp_gather(op(tp_copy(x),
# W_local)) + bias, its bias whole.

from __future__ import annotations

import contextlib
import math
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ctrlhair_tpu_torch.parallel.mesh import (
    global_sum, sharded_params, tp_copy, tp_gather, tp_local)

DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}


def leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    return F.leaky_relu(x, slope)


ACTIVATIONS = {
    'relu': F.relu,
    'lrelu': leaky_relu,
    'tanh': torch.tanh,
    'sigmoid': torch.sigmoid,
    'none': lambda x: x,
}

# Initialisers, named as the flax ones they reproduce.  `fan_in` counts
# kh*kw*in for convs and `in` for dense layers (flax's compute_fans).
#   'torch_uniform': variance_scaling(1/3, fan_in, uniform),
#                    i.e. U(-1/sqrt(fan_in), 1/sqrt(fan_in))
#   'lecun_normal':  flax's default, truncated normal at ±2 std
_TRUNC_STD = 0.87962566103423978   # std of a unit normal truncated at ±2


def init_kernel_(w: torch.Tensor, kind: str, fan_in: int,
                 gen: torch.Generator) -> None:
    with torch.no_grad():
        if kind == 'torch_uniform':
            bound = 1.0 / math.sqrt(fan_in)
            w.uniform_(-bound, bound, generator=gen)
        elif kind == 'lecun_normal':
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=gen)
        else:
            raise ValueError(f'unknown kernel init: {kind}')


class _ColumnParallel:
    """The column-parallel mode of a layer (set_tp): `tp_mesh` None, or the
    mesh whose tp rank's slice of the output features the weight holds
    (along WEIGHT_DIM); the output's features lie along OUT_DIM."""
    WEIGHT_DIM = 0
    OUT_DIM = 1
    tp_mesh = None

    def _column_parallel(self, op, x: torch.Tensor, weight: torch.Tensor,
                         bias: Optional[torch.Tensor]) -> torch.Tensor:
        mesh = self.tp_mesh
        if mesh is None:
            return op(x, weight, bias)
        y = tp_gather(op(tp_copy(x, mesh), weight, None), mesh,
                      self.OUT_DIM % x.dim())
        if bias is None:
            return y
        return y + bias.view((-1,) + (1,) * (y.dim() - 1 - self.OUT_DIM
                                             % y.dim()))


class Conv(_ColumnParallel, nn.Conv2d):
    """flax nn.Conv counterpart: Conv2d run in the compute dtype."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding: int = 0, bias: bool = True,
                 dtype: torch.dtype = torch.float32,
                 init: str = 'lecun_normal'):
        super().__init__(cin, cout, kernel, stride, padding, bias=bias)
        self.compute_dtype = dtype
        self.kernel_init = init

    def reset_parameters(self, gen: Optional[torch.Generator] = None):
        if gen is None:          # called by nn.Conv2d.__init__
            return
        init_kernel_(self.weight, self.kernel_init,
                     self.in_channels * self.kernel_size[0]
                     * self.kernel_size[1], gen)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        cd = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(cd)
        return self._column_parallel(
            lambda x, w, b: F.conv2d(x, w, b, self.stride, self.padding),
            x.to(cd), self.weight.to(cd), bias)


class ConvTranspose(_ColumnParallel, nn.ConvTranspose2d):
    """flax nn.ConvTranspose counterpart (weights in torch's [in,out,kh,kw]
    layout, i.e. the flax kernel spatially flipped; see convert.py)."""
    WEIGHT_DIM = 1

    def __init__(self, cin: int, cout: int, kernel: int, stride: int,
                 padding: int, output_padding: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(cin, cout, kernel, stride, padding, output_padding,
                         bias=bias)
        self.compute_dtype = dtype

    def reset_parameters(self, gen: Optional[torch.Generator] = None):
        if gen is None:
            return
        init_kernel_(self.weight, 'lecun_normal',
                     self.in_channels * self.kernel_size[0]
                     * self.kernel_size[1], gen)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        cd = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(cd)
        return self._column_parallel(
            lambda x, w, b: F.conv_transpose2d(x, w, b, self.stride,
                                               self.padding,
                                               self.output_padding),
            x.to(cd), self.weight.to(cd), bias)


class Dense(_ColumnParallel, nn.Linear):
    """flax nn.Dense counterpart: Linear run in the compute dtype."""
    OUT_DIM = -1

    def __init__(self, cin: int, cout: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32,
                 init: str = 'lecun_normal'):
        super().__init__(cin, cout, bias=bias)
        self.compute_dtype = dtype
        self.kernel_init = init

    def reset_parameters(self, gen: Optional[torch.Generator] = None):
        if gen is None:
            return
        init_kernel_(self.weight, self.kernel_init, self.in_features, gen)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        cd = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(cd)
        return self._column_parallel(F.linear, x.to(cd), self.weight.to(cd),
                                     bias)


def reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """F.pad(x, (pad,) * 4, mode='reflect') by slices and flips: the same
    values, and a backward without atomics (CUDA's reflection-pad backward
    adds with them, so two runs of one training step would part in their
    last bits)."""
    x = torch.cat([x[..., 1:pad + 1].flip(-1), x,
                   x[..., -pad - 1:-1].flip(-1)], -1)
    return torch.cat([x[..., 1:pad + 1, :].flip(-2), x,
                      x[..., -pad - 1:-1, :].flip(-2)], -2)


class TorchConv(nn.Module):
    """Conv2d with torch padding semantics ('zero' or 'reflect'), kernel
    init variance_scaling(1/3, fan_in, uniform)."""

    def __init__(self, cin: int, features: int, kernel: int = 3,
                 stride: int = 1, pad: int = 0, use_bias: bool = True,
                 pad_type: str = 'zero', dtype: torch.dtype = torch.float32):
        super().__init__()
        if pad_type not in ('zero', 'reflect'):
            raise ValueError(f'unsupported pad_type: {pad_type}')
        self.pad = pad
        self.pad_type = pad_type
        self.conv = Conv(cin, features, kernel, stride,
                         pad if pad_type == 'zero' else 0, bias=use_bias,
                         dtype=dtype, init='torch_uniform')

    def forward(self, x):
        if self.pad > 0 and self.pad_type == 'reflect':
            x = reflect_pad(x, self.pad)
        return self.conv(x)


class TorchConvTranspose(nn.Module):
    """ConvTranspose2d(k, s, padding, output_padding) as torch defines it."""

    def __init__(self, cin: int, features: int, kernel: int = 3,
                 stride: int = 2, pad: int = 1, output_pad: int = 1,
                 use_bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = ConvTranspose(cin, features, kernel, stride, pad,
                                  output_pad, bias=use_bias, dtype=dtype)

    def forward(self, x):
        return self.conv(x)


def _promoted(x: torch.Tensor) -> torch.Tensor:
    """x in the dtype the norms take their statistics in: float32, or
    float64 for float64 activations."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


class InstanceNorm(nn.Module):
    """InstanceNorm2d(affine=False), eps 1e-5; statistics in float32."""

    def __init__(self, eps: float = 1e-5, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.dtype = dtype

    def forward(self, x):
        x32 = _promoted(x)
        var, mean = torch.var_mean(x32, dim=(2, 3), keepdim=True,
                                   correction=0)
        return ((x32 - mean) * torch.rsqrt(var + self.eps)).to(self.dtype)


def _channel_shape(x: torch.Tensor):
    return (1, -1) + (1,) * (x.dim() - 2)


class SampleLayerNorm(nn.Module):
    """The shape branch's layer norm: over the whole sample, UNBIASED std,
    (x - mean) / (std + eps), per-channel affine; statistics in float32."""

    def __init__(self, features: int, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.gamma = nn.Parameter(torch.empty(features))
        self.beta = nn.Parameter(torch.empty(features))
        self.eps = eps
        self.dtype = dtype

    def reset_parameters(self, gen: torch.Generator):
        with torch.no_grad():
            self.gamma.uniform_(0.0, 1.0, generator=gen)
            self.beta.zero_()

    def forward(self, x):
        x32 = _promoted(x)
        dims = tuple(range(1, x.dim()))
        n = x[0].numel()
        mean = x32.mean(dim=dims, keepdim=True)
        var = ((x32 - mean) ** 2).sum(dim=dims, keepdim=True) / max(n - 1, 1)
        y = (x32 - mean) / (torch.sqrt(var) + self.eps)
        shape = _channel_shape(x)
        y = y * self.gamma.view(shape) + self.beta.view(shape)
        return y.to(self.dtype)


BN_MOMENTUM = 0.9        # flax's momentum; torch's momentum 0.1


class RunningBatchNorm(nn.Module):
    """flax nn.BatchNorm, channel dim 1.

    At inference (`train=False`) it normalises with the running statistics.
    In train mode it normalises with the batch's mean and biased variance
    (E[x^2] - E[x]^2, floored at 0, as flax's fast variance) and updates
    the running ones in place as flax does, running = 0.9 * running +
    0.1 * batch, the variance biased too (F.batch_norm would take the
    unbiased one).  Normalises in float32 (in float64 for float64 inputs:
    flax's promote_types(dtype, float32)) and returns the compute dtype.
    `affine=False` is the parameter-free norm of ACE.  With a mesh
    (`set_sync`) the batch's [mean, E[x^2]] are averaged over the ranks by
    one differentiable collective before the variance is formed, as flax's
    pmean over axis_name, so every rank normalises with the global
    statistics and keeps the same running ones (torch's SyncBatchNorm would
    keep the unbiased variance)."""

    def __init__(self, features: int, affine: bool = True, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32, train: bool = False):
        super().__init__()
        self.register_buffer('running_mean', torch.zeros(features))
        self.register_buffer('running_var', torch.ones(features))
        if affine:
            self.weight = nn.Parameter(torch.ones(features))
            self.bias = nn.Parameter(torch.zeros(features))
        else:
            self.weight = self.bias = None
        self.eps = eps
        self.dtype = dtype
        self.train_mode = train
        self.mesh = None

    def reset_parameters(self, gen: torch.Generator):
        with torch.no_grad():
            self.running_mean.zero_()
            self.running_var.fill_(1.0)
            if self.weight is not None:
                self.weight.fill_(1.0)
                self.bias.zero_()

    def forward(self, x):
        shape = _channel_shape(x)
        x32 = _promoted(x)
        if self.train_mode:
            dims = (0,) + tuple(range(2, x.dim()))
            mean = x32.mean(dim=dims)
            mean2 = (x32 * x32).mean(dim=dims)
            if self.mesh is not None:
                mean, mean2 = global_sum(torch.stack([mean, mean2])
                                         / self.mesh.world, self.mesh)
            var = torch.clamp_min(mean2 - mean * mean, 0.0)
            with torch.no_grad():
                m = BN_MOMENTUM
                self.running_mean.copy_(m * self.running_mean
                                        + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps)
        if self.weight is not None:
            mul = mul * self.weight
        y = (x32 - mean.view(shape)) * mul.view(shape)
        if self.bias is not None:
            y = y + self.bias.view(shape)
        return y.to(self.dtype)


class BatchNorm(nn.Module):
    """layers.BatchNorm counterpart: a RunningBatchNorm named 'bn'."""

    def __init__(self, features: int, affine: bool = True,
                 dtype: torch.dtype = torch.float32, train: bool = False):
        super().__init__()
        self.bn = RunningBatchNorm(features, affine, dtype=dtype, train=train)

    def forward(self, x):
        return self.bn(x)


class LayerNorm(nn.Module):
    """flax nn.LayerNorm over the last dim (LinearBlock's 'ln')."""

    def __init__(self, features: int, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.eps = eps
        self.dtype = dtype

    def reset_parameters(self, gen: torch.Generator):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x):
        xp = _promoted(x)
        return F.layer_norm(xp, x.shape[-1:], self.weight.to(xp.dtype),
                            self.bias.to(xp.dtype), self.eps).to(self.dtype)


def make_norm(norm: str, features: int, *,
              dtype: torch.dtype = torch.float32, linear: bool = False,
              train: bool = False):
    """Map the reference's norm strings to modules (or None).  'ln' is
    torch's LayerNorm in a LinearBlock and SampleLayerNorm in a ConvBlock,
    as in the JAX twin."""
    if norm == 'none':
        return None
    if norm == 'in':
        return InstanceNorm(dtype=dtype)
    if norm == 'ln':
        if linear:
            return LayerNorm(features, dtype=dtype)
        return SampleLayerNorm(features, dtype=dtype)
    if norm == 'bn':
        return BatchNorm(features, affine=True, dtype=dtype, train=train)
    raise ValueError(f'unsupported norm: {norm}')


def dropout(x: torch.Tensor, rate: float, keep: torch.Tensor) -> torch.Tensor:
    """flax nn.Dropout: kept units divided by the keep probability, the
    others zero; `keep` is the boolean keep mask of x's shape."""
    keep_prob = 1.0 - rate
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))


class LinearBlock(nn.Module):
    """fc -> norm -> activation -> dropout (train mode only)."""

    def __init__(self, cin: int, features: int, norm: str = 'none',
                 activation: str = 'relu', use_bias: bool = True,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0,
                 train: bool = False):
        super().__init__()
        self.fc = Dense(cin, features, bias=use_bias, dtype=dtype,
                        init='torch_uniform')
        self.norm = make_norm(norm, features, dtype=dtype, linear=True,
                              train=train)
        self.activation = activation
        self.dropout = dropout
        self.train_mode = train

    def forward(self, x, keep: Optional[torch.Tensor] = None):
        """`keep`: the dropout keep mask, needed in train mode when the
        block drops units."""
        x = self.fc(x)
        if self.norm is not None:
            x = self.norm(x)
        x = ACTIVATIONS[self.activation](x)
        if self.dropout > 0 and self.train_mode:
            if keep is None:
                raise ValueError('LinearBlock: train mode with dropout needs '
                                 'a keep mask')
            x = dropout(x, self.dropout, keep)
        return x


class ConvBlock(nn.Module):
    """pad -> conv -> norm -> activation."""

    def __init__(self, cin: int, features: int, kernel: int, stride: int,
                 pad: int = 0, norm: str = 'none', activation: str = 'relu',
                 pad_type: str = 'zero', use_bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = TorchConv(cin, features, kernel, stride, pad,
                              use_bias=use_bias, pad_type=pad_type,
                              dtype=dtype)
        self.norm = make_norm(norm, features, dtype=dtype)
        self.activation = activation

    def forward(self, x):
        x = self.conv(x)
        if self.norm is not None:
            x = self.norm(x)
        return ACTIVATIONS[self.activation](x)


class MLP(nn.Module):
    """Stack of LinearBlocks + a bare linear head.  In train mode with
    dropout, each hidden layer drops units by a keep mask: the caller's
    (`keep_masks`, one [N, hidden_dim] bool tensor a hidden layer) or,
    given none, one drawn from `self.generator` (a torch.Generator on the
    input's device; seed 0 unless the caller sets another)."""

    def __init__(self, cin: int, hidden_dim: int, hidden_layers: int,
                 out_dim: int, norm: str = 'none', activation: str = 'lrelu',
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0,
                 train: bool = False):
        super().__init__()
        dims = [cin] + [hidden_dim] * hidden_layers
        for i in range(hidden_layers):
            self.add_module(f'layer_{i}', LinearBlock(
                dims[i], hidden_dim, norm, activation, dtype=dtype,
                dropout=dropout, train=train))
        self.hidden_layers = hidden_layers
        self.hidden_dim = hidden_dim
        self.dropout = dropout
        self.head = LinearBlock(dims[-1], out_dim, 'none', 'none',
                                dtype=dtype)
        self.generator: Optional[torch.Generator] = None

    def drops(self) -> bool:
        """Whether a forward pass now needs keep masks."""
        return self.dropout > 0 and self.layer_0.train_mode \
            if self.hidden_layers else False

    def forward(self, x, keep_masks: Optional[list] = None):
        if self.drops() and keep_masks is None:
            if self.generator is None or \
                    self.generator.device != x.device:
                self.generator = torch.Generator(x.device).manual_seed(0)
            keep_masks = [m.to(x.device) for m in keep_masks_like(
                x.shape[0], self.hidden_dim, self.hidden_layers,
                self.dropout, self.generator)]
        for i in range(self.hidden_layers):
            keep = keep_masks[i] if keep_masks is not None else None
            x = getattr(self, f'layer_{i}')(x, keep)
        return self.head(x)


def keep_masks_like(n: int, width: int, layers: int, rate: float,
                    generator: torch.Generator) -> list:
    """`layers` dropout keep masks [n, width], Bernoulli(1 - rate), drawn
    from `generator` on its device."""
    return [torch.rand((n, width), generator=generator,
                       device=generator.device) < 1.0 - rate
            for _ in range(layers)]


def set_compute_dtype(module: nn.Module, dtype: torch.dtype) -> None:
    """Run every layer under `module` in `dtype` (parameters keep theirs),
    as building it with `dtype=` does."""
    for m in module.modules():
        if hasattr(m, 'compute_dtype'):
            m.compute_dtype = dtype
        if isinstance(getattr(m, 'dtype', None), torch.dtype):
            m.dtype = dtype


def set_train(module: nn.Module, train: bool) -> None:
    """Set the train mode of every layer under `module` that has one (as
    building the flax module with `train=` does)."""
    for m in module.modules():
        if hasattr(m, 'train_mode'):
            m.train_mode = train


def set_sync(module: nn.Module, mesh) -> None:
    """Give every BatchNorm under `module` the global batch's statistics
    over `mesh` in train mode (None: this process's batch), as building the
    flax module with axis_name='dp' does."""
    for m in module.modules():
        if isinstance(m, RunningBatchNorm):
            m.mesh = mesh


def set_tp(module: nn.Module, mesh) -> None:
    """Shard `module` over the tp axis of `mesh` as JAX's shard_params
    places it: every weight that parallel.mesh.param_shardings shards (a
    Conv, ConvTranspose or Dense kernel whose output features split over
    tp) becomes this rank's slice, and its layer runs column-parallel.
    Any other sharded parameter raises.  mesh None or tp = 1: nothing
    changes."""
    owners = dict(module.named_modules())
    for name, dim in sharded_params(module, mesh).items():
        mod_path, _, leaf = name.rpartition('.')
        owner = owners[mod_path]
        if not isinstance(owner, _ColumnParallel) or leaf != 'weight' \
                or dim != owner.WEIGHT_DIM or owner.tp_mesh is not None:
            raise ValueError(f'set_tp: {name} cannot run column-parallel')
        w = owner.weight
        owner.weight = nn.Parameter(tp_local(w.detach(), mesh, dim).clone(),
                                    requires_grad=w.requires_grad)
        owner.tp_mesh = mesh


def tp_shards(module: nn.Module) -> Dict[str, Tuple[object, int]]:
    """{parameter name: (mesh, dim)} of the weights under `module` that
    hold a tp rank's slice (set_tp)."""
    return {f'{path}.weight' if path else 'weight':
            (m.tp_mesh, m.WEIGHT_DIM)
            for path, m in module.named_modules()
            if isinstance(m, _ColumnParallel) and m.tp_mesh is not None}


def init_parameters_(module: nn.Module, gen: torch.Generator) -> None:
    """Re-draw every parameter of `module` from its flax initialiser, in
    module order, from one generator.  Modules with parameters of their own
    (SubspaceLayer, ACE) define `reset_parameters(gen)`."""
    for m in module.modules():
        reset = getattr(m, 'reset_parameters', None)
        if reset is not None:
            reset(gen)


def sn_matrix(w: torch.Tensor) -> torch.Tensor:
    """The matrix whose spectral norm divides a weight: JAX's kernel
    reshaped to [-1, out], i.e. an OIHW conv weight as HWIO [kh*kw*in,
    out] (not torch's [out, in*kh*kw]: the same sigma, but another u, and u
    is state that carries across steps); a Dense weight [out, in] as [in,
    out]."""
    if w.dim() == 4:
        return w.permute(2, 3, 1, 0).reshape(-1, w.shape[0])
    return w.t()


def spectral_normalize(w: torch.Tensor, u: torch.Tensor,
                       n_iter: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """(w / sigma, new u) by `n_iter` power iterations from u, with JAX's
    1e-12 guards.  The gradient flows through v, the new u and sigma, as
    in JAX (torch.nn.utils.spectral_norm computes u and v without one);
    only the returned u is detached."""
    mat = sn_matrix(w)
    for _ in range(n_iter):
        v = mat.t() @ u
        v = v / (torch.linalg.vector_norm(v) + 1e-12)
        u = mat @ v
        u = u / (torch.linalg.vector_norm(u) + 1e-12)
    sigma = u @ (mat @ v)
    return w / sigma, u.detach()


def spectral_normalize_tree(params: Mapping[str, torch.Tensor],
                            u_tree: Mapping[str, torch.Tensor],
                            n_iter: int = 1
                            ) -> Tuple[Dict[str, torch.Tensor],
                                       Dict[str, torch.Tensor]]:
    """Port of ctrlhair_tpu.models.layers.spectral_normalize_tree over
    parameters by name: every weight named in `u_tree` normalised,
    -> ({name: normalised weight}, {name: new u})."""
    out_w, out_u = {}, {}
    for name, u in u_tree.items():
        out_w[name], out_u[name] = spectral_normalize(params[name], u,
                                                      n_iter)
    return out_w, out_u


@contextlib.contextmanager
def replaced_parameters(module: nn.Module,
                        values: Mapping[str, torch.Tensor]):
    """Run `module` with the named parameters replaced by these tensors
    (the spectrally normalised weights, which carry the graph back to the
    parameters), as torch.func.functional_call does; the originals come
    back on exit.  Keep the backward inside the context when a block is
    rematerialised: its recompute reads the parameters again."""
    owners = dict(module.named_modules())
    saved = []
    try:
        for name, value in values.items():
            mod_path, _, attr = name.rpartition('.')
            owner = owners[mod_path]
            saved.append((owner, attr, owner._parameters[attr]))
            owner._parameters[attr] = value
        yield
    finally:
        for owner, attr, param in reversed(saved):
            owner._parameters[attr] = param
