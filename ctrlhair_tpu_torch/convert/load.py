# Load the checkpoints the JAX package's trainers write, and the
# reference's PyTorch checkpoints, into a HairEditor.
#
# Port of ctrlhair_tpu/convert/load.py (load_native_params,
# load_trained_root, load_reference_params and load_reference_tree; the
# last two at the end of this file): each family's checkpoint directory
# holds the
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
# generator tree and has no counterpart in the editor: it is dropped.  So
# are the face parser's two auxiliary heads (`conv_out16`, `conv_out32`,
# training/bisenet_trainer.py), which flax's apply of the inference model
# ignores and the editor's BiSeNet does not build.
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

from ctrlhair_tpu_torch.convert import load_variables
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


# training-only subtrees of a family's variables, by family
TRAIN_ONLY = {'shape': ('geo_head',),
              'bisenet': ('conv_out16', 'conv_out32')}


def _inference(family: str, variables: Mapping) -> Dict[str, Any]:
    """A family's variables without its training-only subtrees."""
    drop = TRAIN_ONLY.get(family, ())
    return {col: {k: v for k, v in sub.items() if k not in drop}
            for col, sub in variables.items()}


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
            return {'shape': _inference('shape', _variables(
                gen['params'], gen.get('batch_stats')))}
    elif _is_variables(tree):              # editor-shaped deployment
        return {family: _inference(family, tree)}
    elif family == 'sean':
        if {'step', 'gen', 'gen_stats'} <= keys:
            return {'sean': _variables(tree['gen']['params']['params'],
                                       tree['gen_stats'])}
    elif {'step', 'model', 'stats'} <= keys:     # predictors, BiSeNet
        return {family: _inference(family, _variables(
            tree['model']['params']['params'], tree['stats']))}
    raise ValueError(f'{family}: checkpoint keys {sorted(map(str, keys))} '
                     'match no checkpoint contract')


def _load_family(editor, family: str, variables: Mapping) -> None:
    """from_flax's layout rules into editor.<family>, strictly."""
    try:
        load_variables(getattr(editor, family), family, variables)
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


# ------------------------------------------------ reference checkpoints
def torch_load(path: str):
    """A reference PyTorch checkpoint, on the CPU.  Full pickles, as the
    reference saves some of them (a whole SEAN netG module): read only
    checkpoints you trust."""
    import torch
    return torch.load(path, map_location='cpu', weights_only=False)


def load_reference_params(editor, *,
                          sean_path: Optional[str] = None,
                          bisenet_path: Optional[str] = None,
                          color_texture_ckpt: Optional[str] = None,
                          shape_ckpt: Optional[str] = None,
                          rgb_predictor_ckpt: Optional[str] = None,
                          curliness_predictor_ckpt: Optional[str] = None,
                          style_fallback_dir: Optional[str] = None
                          ) -> Dict[str, str]:
    """Load whichever reference PyTorch checkpoints exist into the editor's
    families, as the JAX package's load_reference_params does: each state
    dict goes through convert.torch_import (the reference layout -> flax
    layout, 'module.' prefixes stripped) and then from_flax's rules into
    the family, strictly.  Branch checkpoints are the reference's
    {'Model_G', 'Model_D', ...} / {'Predictor'} dicts.  An absent path
    leaves the family as it is.  Returns {family: path} of what loaded."""
    from ctrlhair_tpu_torch.convert import torch_import as ti

    cfg = editor.cfg
    loaded: Dict[str, str] = {}

    def exists(path):
        return bool(path) and os.path.exists(path)

    def put(family, variables, path):
        _load_family(editor, family, _inference(family, variables))
        loaded[family] = path

    if exists(sean_path):
        sd = torch_load(sean_path)
        if hasattr(sd, 'state_dict'):
            sd = sd.state_dict()
        put('sean', ti.convert_sean(
            ti.strip_ddp_prefix(sd), ngf=cfg.sean.ngf,
            semantic_nc=cfg.sean.semantic_nc,
            style_dim=cfg.sean.style_dim), sean_path)
    if exists(bisenet_path):
        put('bisenet', ti.convert_bisenet(
            ti.strip_ddp_prefix(torch_load(bisenet_path))), bisenet_path)
    if exists(color_texture_ckpt):
        ckpt = torch_load(color_texture_ckpt)
        put('ct_gen', ti.convert_ct_generator(
            ti.strip_ddp_prefix(ckpt['Model_G']),
            cfg.color_texture.g_hidden_layer_num), color_texture_ckpt)
        put('ct_dis', ti.convert_ct_discriminator(
            ti.strip_ddp_prefix(ckpt['Model_D']),
            cfg.color_texture.d_hidden_layer_num), color_texture_ckpt)
    if exists(shape_ckpt):
        ckpt = torch_load(shape_ckpt)
        put('shape', ti.convert_shape_generator(
            ti.strip_ddp_prefix(ckpt['Model_G']), cfg.shape.layer_num,
            img_size=cfg.shape.img_size,
            hidden_in_channel=cfg.shape.hidden_in_channel,
            max_channel=cfg.shape.max_channel), shape_ckpt)
    for family, path, pcfg in (
            ('rgb_pred', rgb_predictor_ckpt, cfg.rgb_predictor),
            ('curliness_pred', curliness_predictor_ckpt,
             cfg.curliness_predictor)):
        if exists(path):
            ckpt = torch_load(path)
            sd = ti.strip_ddp_prefix(ckpt.get('Predictor', ckpt))
            put(family, ti.convert_predictor(sd, pcfg.hidden_layer_num,
                                             pcfg.norm), path)
    if style_fallback_dir and os.path.isdir(style_fallback_dir):
        editor.load_style_fallback(style_fallback_dir)
    return loaded


def load_reference_tree(editor, root: str) -> Dict[str, str]:
    """load_reference_params from the reference repository's on-disk
    layout rooted at `root`: SEAN's and BiSeNet's checkpoints under
    external_model_params, each branch's newest checkpoint (its
    `latest_checkpoint` manifest, else the last `*.ckpt` by name) under
    model_trained, the median style codes under sean_codes."""

    def branch_ckpt(subdir):
        d = os.path.join(root, subdir, 'checkpoints')
        if not os.path.isdir(d):
            return None
        manifest = os.path.join(d, 'latest_checkpoint')
        if os.path.exists(manifest):
            with open(manifest) as f:
                return os.path.join(d, f.readline().strip())
        cands = sorted(f for f in os.listdir(d) if f.endswith('.ckpt'))
        return os.path.join(d, cands[-1]) if cands else None

    return load_reference_params(
        editor,
        sean_path=os.path.join(
            root, 'external_model_params', 'sean_checkpoints',
            'CelebA-HQ_pretrained', 'latest_net_G.pth'),
        bisenet_path=os.path.join(
            root, 'external_model_params', 'face_parsing_79999_iter.pth'),
        color_texture_ckpt=branch_ckpt(
            'model_trained/color_texture/045__color_texture_final'),
        shape_ckpt=branch_ckpt(
            'model_trained/shape/054__succeed__049__gan_fake_0.5_from_noise'),
        rgb_predictor_ckpt=branch_ckpt(
            'model_trained/color_encoder/p004___pca_std'),
        curliness_predictor_ckpt=branch_ckpt(
            'model_trained/curliness_classifier/p002___curliness'),
        style_fallback_dir=os.path.join(
            root, 'sean_codes', 'styles_test', 'mean_style_code', 'median'))
