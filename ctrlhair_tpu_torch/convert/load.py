# Load the checkpoints the JAX package's trainers write into a HairEditor.
#
# Port of ctrlhair_tpu/convert/load.py (load_native_params,
# load_trained_root): each family's checkpoint directory holds the
# manifest and `%07d.ckpt` files of utils/checkpoint.py.  Two contracts
# exist, told apart by the keys of the decoded tree:
#   * deployment trees, as scripts/train_soak.py ships them: colour/texture
#     {'gen', 'dis'}, shape {'gen'}, each a variables dict; BiSeNet, the
#     predictors and SEAN in the editor's own shape {'params'[,
#     'batch_stats']};
#   * the full train state a trainer saves (training/loop.py): the
#     generator's, discriminator's or model's variables and the running
#     statistics are picked out of it, the optimiser state left behind.
# The shape trainer's `geo_head` (training/shape_trainer.py) rides in its
# generator tree and has no counterpart in the editor: it is dropped.
# bfloat16 leaves arrive as float32 (flax_msgpack widens them).  Each family
# goes through convert.from_flax's layout rules into its submodule with
# load_state_dict(strict=True): every key of the family must be present and
# none may be unknown or of another shape.
# Where the JAX loader swallows a checkpoint that matches no contract and
# leaves the family at its initialisation, this one raises.  An absent
# directory leaves the family as it is, as there.

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional

from ctrlhair_tpu_torch.convert import from_flax
from ctrlhair_tpu_torch.utils.checkpoint import load_checkpoint

_VARIABLES = {'params', 'batch_stats'}


def _variables(params: Mapping, stats) -> Dict[str, Any]:
    """{'params': ..., 'batch_stats': ...}; empty statistics are left out,
    as a model without batch norm has none."""
    out = {'params': params}
    if stats:
        out['batch_stats'] = stats
    return out


def _is_variables(tree) -> bool:
    return (isinstance(tree, Mapping) and 'params' in tree
            and set(tree) <= _VARIABLES)


def _gan_state(tree) -> bool:
    """A GANTrainState: step, gen/dis ModelOpts (params + opt_state)."""
    return ({'step', 'gen', 'dis'} <= set(tree)
            and all(isinstance(tree[k], Mapping) and 'params' in tree[k]
                    for k in ('gen', 'dis')))


def pick_variables(family: str, tree) -> Dict[str, Any]:
    """Decoded checkpoint -> {editor family: variables dict}."""
    if not isinstance(tree, Mapping):
        raise ValueError(f'{family}: a checkpoint of {type(tree).__name__}')
    keys = set(tree)
    if family == 'color_texture':
        if keys == {'gen', 'dis'}:
            return {'ct_gen': tree['gen'], 'ct_dis': tree['dis']}
        if _gan_state(tree):
            return {'ct_gen': tree['gen']['params'],
                    'ct_dis': tree['dis']['params']}
    elif family == 'shape':
        if keys == {'gen'}:
            gen = tree['gen']
        elif _gan_state(tree):
            gen = tree['gen']['params']
        else:
            gen = None
        if _is_variables(gen):
            params = {k: v for k, v in gen['params'].items()
                      if k != 'geo_head'}
            return {'shape': _variables(params, gen.get('batch_stats'))}
    elif _is_variables(tree):              # editor-shaped deployment
        return {family: tree}
    elif family == 'sean':
        if {'step', 'gen', 'gen_stats'} <= keys:
            return {'sean': _variables(tree['gen']['params']['params'],
                                       tree['gen_stats'])}
    elif {'step', 'model', 'stats'} <= keys:     # predictors, BiSeNet
        return {family: _variables(tree['model']['params']['params'],
                                   tree['stats'])}
    raise ValueError(f'{family}: checkpoint keys {sorted(map(str, keys))} '
                     'match no checkpoint contract')


def _load_family(editor, family: str, variables: Mapping) -> None:
    """from_flax's layout rules into editor.<family>, strictly."""
    prefix = family + '.'
    module = getattr(editor, family)
    try:
        state = from_flax({family: variables})
        module.load_state_dict({k[len(prefix):]: v for k, v in state.items()},
                               strict=True)
    except (KeyError, RuntimeError) as e:
        raise ValueError(f'{family}: the checkpoint does not fit the '
                         f'editor: {e}') from e


def load_native_params(editor, *,
                       color_texture_dir: Optional[str] = None,
                       shape_dir: Optional[str] = None,
                       rgb_predictor_dir: Optional[str] = None,
                       curliness_predictor_dir: Optional[str] = None,
                       bisenet_dir: Optional[str] = None,
                       sean_dir: Optional[str] = None) -> Dict[str, int]:
    """Load the newest checkpoint of each given directory into the editor's
    families.  Returns {family: step} of what was loaded; a family whose
    directory is absent or holds no checkpoint keeps its weights."""
    dirs = {'color_texture': color_texture_dir, 'shape': shape_dir,
            'rgb_pred': rgb_predictor_dir,
            'curliness_pred': curliness_predictor_dir,
            'bisenet': bisenet_dir, 'sean': sean_dir}
    loaded = {}
    for family, ckpt_dir in dirs.items():
        if not ckpt_dir or not os.path.isdir(ckpt_dir):
            continue
        res = load_checkpoint(ckpt_dir)
        if res is None:
            continue
        tree, step = res
        try:
            picked = pick_variables(family, tree)
        except (KeyError, TypeError) as e:
            raise ValueError(f'{family}: malformed checkpoint in {ckpt_dir}: '
                             f'{e!r}') from e
        for name, variables in picked.items():
            _load_family(editor, name, variables)
            loaded[name] = step
    return loaded


def family_dirs(root: str) -> Dict[str, Optional[str]]:
    """load_native_params' keyword arguments for a trained root: the
    reference's family directory names (color_encoder, curliness_classifier)
    or the soak workdir's (rgb_predictor, curliness_predictor)."""
    def sub(*names):
        for name in names:
            d = os.path.join(root, name, 'checkpoints')
            if os.path.isdir(d):
                return d
        return None

    return {'color_texture_dir': sub('color_texture'),
            'shape_dir': sub('shape'),
            'bisenet_dir': sub('bisenet'),
            'sean_dir': sub('sean'),
            'rgb_predictor_dir': sub('color_encoder', 'rgb_predictor'),
            'curliness_predictor_dir': sub('curliness_classifier',
                                           'curliness_predictor')}


def load_trained_root(editor, root: str) -> Dict[str, int]:
    """Load every family checkpoint found under `root` into the editor."""
    return load_native_params(editor, **family_dirs(root))
