# The port's checkpoint loader (ctrlhair_tpu_torch/convert/load.py) against
# the JAX package's convert/load.py: the same checkpoint directories, in
# every contract the JAX loader accepts, loaded into the tiny editors of both
# packages; the port's state dict must equal convert.from_flax of the JAX
# editor's parameters exactly (both are float32 copies of the same bits).
# Then the shipped model_trained/ at the published widths of the families it
# holds, Backend() booting from a trained root, and the cases where the port
# raises and the JAX loader would leave a family at its initialisation.
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_pipeline_cfg
from ctrlhair_tpu.convert.load import load_trained_root as jax_load_root
from ctrlhair_tpu.training.predictor_trainer import PredictorTrainer
from ctrlhair_tpu.training.shape_trainer import N_GEO_STATS
from ctrlhair_tpu.utils.checkpoint import save_checkpoint
from ctrlhair_tpu_torch import config as port_cfg
from ctrlhair_tpu_torch.convert import from_flax
from ctrlhair_tpu_torch.convert.load import (family_dirs, load_native_params,
                                             load_trained_root)
from ctrlhair_tpu_torch.pipeline.backend import Backend, repo_path
from ctrlhair_tpu_torch.pipeline.editor import HairEditor
from test_torch_convert import port_config

ALL = {'ct_gen', 'ct_dis', 'shape', 'bisenet', 'sean', 'rgb_pred',
       'curliness_pred'}


def host(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def randomised(tree, seed, dtype=np.float32):
    """The tree's float leaves redrawn (so that a load is visible)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: rng.standard_normal(x.shape).astype(np.float32).astype(
            dtype) if np.issubdtype(x.dtype, np.floating) else x, host(tree))


def without_geo_head(params):
    shape = dict(params['shape'])
    shape['params'] = {k: v for k, v in shape['params'].items()
                       if k != 'geo_head'}
    return {**params, 'shape': shape}


def assert_port_equals_jax(port_editor, jax_editor, families=ALL):
    want = from_flax(without_geo_head(host(jax_editor.params)))
    got = port_editor.state_dict()
    keys = [k for k in want if k.split('.')[0] in families]
    assert keys and set(keys) <= set(got)
    for k in keys:
        assert torch.equal(got[k], want[k]), k


def jax_editor_like(tiny_editor):
    """What the JAX load_native_params reads and writes of an editor (its
    params and cfg), on a copy of the shared tiny editor's parameters."""
    return types.SimpleNamespace(params=dict(tiny_editor.params),
                                 cfg=tiny_editor.cfg)


@pytest.fixture(scope='module')
def trained_root(tmp_path_factory, tiny_editor):
    """One checkpoint directory per family, one contract each:
      color_texture  reduced deployment {'gen', 'dis'}
      shape          reduced {'gen'}, with the shape trainer's geo_head
      bisenet        editor-shaped {'params', 'batch_stats'}
      sean           editor-shaped, bfloat16 leaves
      rgb_predictor  the full PredictorTrainState (soak directory name)
      curliness_classifier  editor-shaped (reference directory name)."""
    root = tmp_path_factory.mktemp('trained')
    cfg, params = tiny_editor.cfg, tiny_editor.params

    def save(name, tree, step):
        save_checkpoint(str(root / name / 'checkpoints'), host(tree), step)

    save('color_texture', {'gen': randomised(params['ct_gen'], 1),
                           'dis': randomised(params['ct_dis'], 2)}, 11)
    # the shape trainer's geometry head (lambda_geo > 0) rides in its
    # generator tree (training/shape_trainer.py)
    gen = randomised(params['shape'], 3)
    gen['params']['geo_head'] = {
        'kernel': np.ones((cfg.shape.hair_dim, N_GEO_STATS), np.float32),
        'bias': np.ones(N_GEO_STATS, np.float32)}
    save('shape', {'gen': gen}, 12)
    save('bisenet', randomised(params['bisenet'], 4), 13)
    save('sean', randomised(params['sean'], 5, jnp.bfloat16), 14)
    pcfg = dataclasses.replace(cfg.rgb_predictor,
                               style_dim=cfg.sean.style_dim)
    state = PredictorTrainer(pcfg).init_state(jax.random.PRNGKey(7))
    state = state.replace(model=state.model.replace(
        params=randomised(state.model.params, 6)),
        stats=randomised(state.stats, 7))
    save('rgb_predictor', state, 15)
    save('curliness_classifier', randomised(params['curliness_pred'], 8), 16)
    return root


@pytest.fixture(scope='module')
def jax_loaded(trained_root, tiny_editor):
    ed = jax_editor_like(tiny_editor)
    jax_load_root(ed, str(trained_root))
    return ed


def test_every_contract_loads_as_in_jax(trained_root, jax_loaded):
    ed = HairEditor(port_config(jax_loaded.cfg), device='cpu')
    loaded = load_trained_root(ed, str(trained_root))
    assert loaded == {'ct_gen': 11, 'ct_dis': 11, 'shape': 12,
                      'bisenet': 13, 'sean': 14, 'rgb_pred': 15,
                      'curliness_pred': 16}
    assert_port_equals_jax(ed, jax_loaded)
    # bfloat16 leaves came in as float32 copies of the rounded values
    w = ed.sean.state_dict()
    assert all(v.dtype == torch.float32 for v in w.values())
    assert all(torch.equal(v, v.bfloat16().float()) for v in w.values())


def test_backend_boots_from_a_trained_root(trained_root, jax_loaded):
    be = Backend(cfg=port_config(jax_loaded.cfg), editor=None, device='cpu',
                 trained_root=str(trained_root))
    assert be.device == torch.device('cpu')
    assert set(be.loaded_families) == ALL
    assert_port_equals_jax(be.editor, jax_loaded)
    # a given editor keeps its weights unless a root is named
    before = {k: v.clone() for k, v in be.editor.state_dict().items()}
    Backend(cfg=be.cfg, editor=be.editor)
    after = be.editor.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)


def test_shipped_model_trained_at_published_widths(tiny_editor):
    """The families shipped in model_trained/ (BiSeNet, colour/texture, both
    predictors) at their published widths; SEAN and the shape VAE, which do
    not ship, at a small width and left at their initialisation.  (The JAX
    loader restores by keys, so the tiny editor's trees serve as its
    targets.)"""
    jed = jax_editor_like(tiny_editor)
    jax_load_root(jed, repo_path('model_trained'))
    ped = HairEditor(port_cfg.PipelineConfig(
        sean=port_cfg.SEANConfig(crop_size=64, ngf=4, zencoder_ngf=4),
        shape=port_cfg.ShapeConfig(img_size=64, layer_num=5, max_channel=64,
                                   hidden_in_channel=8),
        edit_size=64, compute_dtype='float32'), device='cpu')
    loaded = load_trained_root(ped, repo_path('model_trained'))
    shipped = {'ct_gen', 'ct_dis', 'bisenet', 'rgb_pred', 'curliness_pred'}
    assert set(loaded) == shipped
    assert_port_equals_jax(ped, jed, shipped)


def test_mismatched_checkpoints_raise(tmp_path, trained_root, tiny_editor):
    """Where the JAX loader swallows a checkpoint that fits no contract and
    keeps the family's initialisation, the port raises; an absent directory
    leaves the family as it is."""
    cfg = port_config(tiny_pipeline_cfg())
    ed = HairEditor(cfg, device='cpu')
    before = {k: v.clone() for k, v in ed.state_dict().items()}
    assert load_native_params(ed, bisenet_dir=str(tmp_path / 'absent'),
                              sean_dir=None) == {}
    assert all(torch.equal(before[k], v) for k, v in ed.state_dict().items())

    # a colour/texture tree with a layer of another width
    params = host(tiny_editor.params)
    dis = host(params['ct_dis'])
    head = dis['params']['net']['head']['fc']
    head['kernel'] = np.zeros(head['kernel'].shape[:1] + (3,), np.float32)
    save_checkpoint(str(tmp_path / 'ct'),
                    {'gen': params['ct_gen'], 'dis': dis}, 1)
    with pytest.raises(ValueError, match='does not fit'):
        load_native_params(ed, color_texture_dir=str(tmp_path / 'ct'))
    # keys of no contract
    save_checkpoint(str(tmp_path / 'odd'), {'weights': np.zeros(3)}, 1)
    with pytest.raises(ValueError, match='no checkpoint contract'):
        load_native_params(ed, rgb_predictor_dir=str(tmp_path / 'odd'))
    # a leaf the family does not have
    tree = host(tiny_editor.params['curliness_pred'])
    tree['params']['extra'] = {'kernel': np.zeros((2, 2), np.float32)}
    save_checkpoint(str(tmp_path / 'extra'), tree, 1)
    with pytest.raises(ValueError, match='does not fit'):
        load_native_params(ed,
                           curliness_predictor_dir=str(tmp_path / 'extra'))
    # directory names: the reference's first, else the soak's
    dirs = family_dirs(str(trained_root))
    assert dirs['rgb_predictor_dir'].endswith('rgb_predictor/checkpoints')
    assert dirs['curliness_predictor_dir'].endswith(
        'curliness_classifier/checkpoints')


def test_trained_bisenet_checkpoints_load_without_aux_heads(tmp_path,
                                                            tiny_editor):
    """A face-parser train state carries the auxiliary heads conv_out16 /
    conv_out32, which the editor's BiSeNet does not build (flax's apply of
    the inference model ignores them).  The port's checkpoint and JAX's
    both load into HairEditor(device='cpu'), and the parse equals the one
    from the same weights loaded without the heads."""
    from ctrlhair_tpu.training import bisenet_trainer as jbt
    from ctrlhair_tpu_torch.convert import load_variables
    from ctrlhair_tpu_torch.convert.load import pick_variables
    from ctrlhair_tpu_torch.training import bisenet_trainer as pbt
    from ctrlhair_tpu_torch.utils import checkpoint as pckpt
    cfg = port_config(tiny_editor.cfg)
    jstate = jbt.BiSeNetTrainer(tiny_editor.cfg.bisenet).init_state(
        jax.random.PRNGKey(5))
    jstate = jstate.replace(model=jstate.model.replace(
        params=randomised(jstate.model.params, 9)),
        stats=jax.tree_util.tree_map(np.abs, randomised(jstate.stats, 10)))
    save_checkpoint(str(tmp_path / 'jax'), host(jstate), 4)
    pstate = pbt.BiSeNetTrainer(cfg.bisenet, device='cpu').init_state(6)
    pckpt.save_checkpoint(str(tmp_path / 'port'), pstate.to_tree(), 5)
    img = np.random.default_rng(0).integers(0, 256, (1, 96, 96, 3),
                                            dtype=np.uint8)
    ed, ref = HairEditor(cfg, device='cpu'), HairEditor(cfg, device='cpu')
    for name, step in (('jax', 4), ('port', 5)):
        d = str(tmp_path / name)
        tree, _ = pckpt.load_checkpoint(d)
        heads = tree['model']['params']['params']
        assert {'conv_out16', 'conv_out32'} <= set(heads)
        assert load_native_params(ed, bisenet_dir=d) == {'bisenet': step}
        aux = ('conv_out16', 'conv_out32')
        variables = {'params': {k: v for k, v in heads.items()
                                if k not in aux},
                     'batch_stats': {k: v for k, v in tree['stats'].items()
                                     if k not in aux}}
        load_variables(ref.bisenet, 'bisenet', variables)
        assert pick_variables('bisenet', tree)['bisenet'].keys() == \
            variables.keys()
        with torch.no_grad():
            assert torch.equal(ed.parse(img), ref.parse(img))
        got, want = ed.bisenet.state_dict(), ref.bisenet.state_dict()
        assert all(torch.equal(got[k], want[k]) for k in want)
