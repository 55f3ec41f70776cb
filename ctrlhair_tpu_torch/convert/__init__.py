# flax parameter tree -> the port's state dict.
#
# The port names every torch module after its flax counterpart, so a flax
# leaf path maps onto a torch key by a path walk: the collection level
# ('params' / 'batch_stats') is dropped and the leaf is renamed by the
# layout rules below, the inverse of ctrlhair_tpu/convert/torch_import.py:
#   Dense          kernel [in,out]        -> weight [out,in]
#   Conv           kernel [kh,kw,in,out]  -> weight [out,in,kh,kw]
#   ConvTranspose  kernel [kh,kw,in,out]  -> weight [in,out,kh,kw], flipped
#   BatchNorm      scale/bias, batch_stats mean/var
#                                         -> weight/bias, running_mean/var
#   LayerNorm      scale/bias             -> weight/bias
#   own params (fc_mu_kernel [19,D,D] 'rio', SampleLayerNorm gamma/beta,
#   SubspaceLayer U/L/mu, ACE noise_var/blending_*)  -> kept as they are
#   style_fallback [19,D]                 -> the editor's buffer
# Input is the JAX editor's parameter tree as nested dicts of numpy arrays
# (the caller does any device-to-host copy, or convert/load.py decodes a
# checkpoint).  An unknown leaf raises here; a missing one raises when the
# state dict is loaded (strict=True).  to_flax is the inverse for one
# module: its tensors (or tensors laid out like its parameters, such as
# Adam's moments) -> flax variables of numpy arrays, so that the trainers
# write checkpoints the JAX package restores.

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

# flax module paths (family first, collection dropped) of ConvTranspose
# layers; every other 4-d kernel is a Conv
CONV_TRANSPOSE_PATHS = {('sean', 'zencoder', 'up_0', 'conv')}

_KEEP = {'bias', 'gamma', 'beta', 'fc_mu_kernel', 'fc_mu_bias',
         'blending_gamma', 'blending_beta', 'noise_var', 'U', 'L', 'mu'}
_BATCH_STATS = {'mean': 'running_mean', 'var': 'running_var'}


def _convert_param(path: Tuple[str, ...], leaf: str,
                   value: np.ndarray) -> Tuple[str, np.ndarray]:
    if leaf == 'kernel':
        if value.ndim == 2:                          # Dense
            return 'weight', value.T
        if value.ndim == 4 and path in CONV_TRANSPOSE_PATHS:
            return 'weight', value[::-1, ::-1].transpose(2, 3, 0, 1)
        if value.ndim == 4:                          # Conv
            return 'weight', value.transpose(3, 2, 0, 1)
        raise ValueError(f'{"/".join(path)}/kernel: unexpected rank '
                         f'{value.ndim}')
    if leaf == 'scale':
        return 'weight', value
    if leaf in _KEEP:
        return leaf, value
    raise KeyError(f'unknown parameter leaf {"/".join(path + (leaf,))}')


def _tensor(value) -> torch.Tensor:
    """A float32 torch copy (the flax leaves may be read-only views)."""
    return torch.tensor(np.ascontiguousarray(value, np.float32))


def _walk(tree: Mapping[str, Any], prefix: Tuple[str, ...]):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _walk(value, prefix + (key,))
        else:
            yield prefix, key, np.asarray(value)


def from_flax(variables_np: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX HairEditorTPU.params (numpy leaves) -> HairEditor state dict."""
    state = {}
    for family, tree in variables_np.items():
        if not isinstance(tree, Mapping):
            if family != 'style_fallback':
                raise KeyError(f'unknown top-level leaf {family}')
            state[family] = _tensor(tree)
            continue
        for collection, sub in tree.items():
            if collection not in ('params', 'batch_stats'):
                raise KeyError(f'unknown collection {family}/{collection}')
            for path, leaf, value in _walk(sub, (family,)):
                if collection == 'params':
                    name, value = _convert_param(path, leaf, value)
                elif leaf in _BATCH_STATS:
                    name = _BATCH_STATS[leaf]
                else:
                    raise KeyError('unknown batch statistic '
                                   f'{"/".join(path + (leaf,))}')
                key = '.'.join(path + (name,))
                state[key] = _tensor(value)
    return state


def load_variables(module: nn.Module, family: str,
                   variables: Mapping[str, Any]) -> None:
    """Load one module from its flax variables ({'params'[,
    'batch_stats']}) with load_state_dict(strict=True).  `family` is the
    module's editor family name, which from_flax's layout rules key on
    ('sean' for a SEAN)."""
    prefix = family + '.'
    state = from_flax({family: variables})
    module.load_state_dict({k[len(prefix):]: v for k, v in state.items()},
                           strict=True)


def _flax_leaf(owner: nn.Module, family: Optional[str],
               mod_path: str, leaf: str) -> Tuple[str, str, Optional[str]]:
    """(collection, flax leaf name, layout) of one torch tensor: layout
    'dense' [out,in] -> [in,out], 'conv' [out,in,kh,kw] -> [kh,kw,in,out],
    'conv_transpose' [in,out,kh,kw] -> [kh,kw,in,out] flipped, None kept.
    `family` None skips the check that from_flax would invert a
    ConvTranspose."""
    path = tuple(mod_path.split('.')) if mod_path else ()
    key = '.'.join(path + (leaf,))
    if leaf in ('running_mean', 'running_var'):
        return 'batch_stats', leaf[len('running_'):], None
    if leaf == 'weight' and isinstance(owner, nn.ConvTranspose2d):
        if family is not None and \
                (family,) + path not in CONV_TRANSPOSE_PATHS:
            raise ValueError(f'{family}.{key}: a ConvTranspose from_flax '
                             'would not invert')
        return 'params', 'kernel', 'conv_transpose'
    if leaf == 'weight' and isinstance(owner, nn.Conv2d):
        return 'params', 'kernel', 'conv'
    if leaf == 'weight' and isinstance(owner, nn.Linear):
        return 'params', 'kernel', 'dense'
    if leaf == 'weight':                         # BatchNorm, LayerNorm
        return 'params', 'scale', None
    if leaf not in _KEEP:
        raise KeyError(f'unknown parameter {family}.{key}')
    return 'params', leaf, None


def flax_param_layout(module: nn.Module
                      ) -> Dict[str, Tuple[Tuple[str, ...],
                                           Tuple[int, ...], int]]:
    """{torch parameter name: (flax path ('params', ..., leaf), the
    shape in flax's layout, the torch dim that holds the flax layout's
    last axis)} of every parameter of `module`, by to_flax's rules."""
    owners = dict(module.named_modules())
    out = {}
    for key, p in module.named_parameters():
        mod_path, _, leaf = key.rpartition('.')
        collection, name, layout = _flax_leaf(owners[mod_path], None,
                                              mod_path, leaf)
        shape = tuple(p.shape)
        if layout == 'dense':
            shape, last = shape[::-1], 0
        elif layout in ('conv', 'conv_transpose'):
            out_dim = 0 if layout == 'conv' else 1
            shape = shape[2:] + (shape[1 - out_dim], shape[out_dim])
            last = out_dim
        else:
            last = len(shape) - 1
        path = tuple(mod_path.split('.')) if mod_path else ()
        out[key] = ((collection,) + path + (name,), shape, last)
    return out


def to_flax(module: nn.Module, family: str,
            values: Optional[Mapping[str, torch.Tensor]] = None
            ) -> Dict[str, Any]:
    """The inverse of from_flax for one module: `values` (default: its
    state dict; keys as in named_parameters / named_buffers, a subset
    allowed) -> {'params': ..., 'batch_stats': ...} of float32 numpy
    arrays, the second only when a running statistic is among them."""
    if values is None:
        values = module.state_dict()
    owners = dict(module.named_modules())
    out: Dict[str, Any] = {}
    for key, tensor in values.items():
        mod_path, _, leaf = key.rpartition('.')
        value = tensor.detach().float().cpu().numpy()
        collection, name, layout = _flax_leaf(owners[mod_path], family,
                                              mod_path, leaf)
        if layout == 'conv_transpose':
            value = value.transpose(2, 3, 0, 1)[::-1, ::-1]
        elif layout == 'conv':
            value = value.transpose(2, 3, 1, 0)
        elif layout == 'dense':
            value = value.T
        node = out.setdefault(collection, {})
        for part in (tuple(mod_path.split('.')) if mod_path else ()):
            node = node.setdefault(part, {})
        node[name] = np.array(value, copy=True)   # not a view of live data
    return out
