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
# (the caller does any device-to-host copy).  An unknown leaf raises here; a
# missing one raises when the state dict is loaded (strict=True).

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

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
