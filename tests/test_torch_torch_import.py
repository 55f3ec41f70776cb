# The port's import of reference PyTorch checkpoints
# (ctrlhair_tpu_torch/convert/torch_import.py, its own copy of the JAX
# converter, and convert/load.load_reference_params) against the JAX
# package's, on the synthetic reference-layout state dicts of the JAX
# tests (tests/test_convert.py, tests/test_convert_sean.py).  Bar: the
# copy's flax trees equal the JAX converter's exactly; each family lands
# in the port's modules strictly; load_reference_params on the port's
# editor equals from_flax of the JAX editor's parameters after the JAX
# load_reference_params, exactly.
import copy
import dataclasses

import jax
import numpy as np
import pytest
import torch

from ctrlhair_tpu.convert import load as jload
from ctrlhair_tpu.convert import torch_import as jti
from ctrlhair_tpu_torch.convert import from_flax, load_variables
from ctrlhair_tpu_torch.convert import torch_import as ti
from ctrlhair_tpu_torch.convert.load import (
    load_reference_params, load_reference_tree)
from ctrlhair_tpu_torch.pipeline.editor import HairEditor
from test_convert import _fake_ct_gen_sd, _fake_mlp_sd, _fake_shape_gen_sd
from test_convert_sean import _fake_sean_sd
from ctrlhair_tpu_torch.constants import HAIR_IDX as HAIR
from test_torch_convert import (  # noqa: F401 (autouse)
    one_torch_thread, port_config)


def assert_same_tree(got, ref):
    g = jax.tree_util.tree_flatten_with_path(got)[0]
    r = jax.tree_util.tree_flatten_with_path(ref)[0]
    assert [p for p, _ in g] == [p for p, _ in r]
    for (path, a), (_, b) in zip(g, r):
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=str(path))


def fake_state_dicts(cfg, seed=0):
    """{family: reference-layout state dict} for the tiny editor config."""
    rng = np.random.default_rng(seed)
    ct = cfg.color_texture
    out_dim = 1 + ct.noise_dim + 1 + ct.curliness_dim
    rp, cp = cfg.rgb_predictor, cfg.curliness_predictor
    code = cfg.sean.style_dim
    return {
        'sean': {'module.' + k: v
                 for k, v in _fake_sean_sd(rng, cfg.sean).items()},
        'ct_gen': _fake_ct_gen_sd(rng, ct),
        'ct_dis': _fake_mlp_sd(rng, 'net', [code] + [ct.d_hidden_dim]
                               * ct.d_hidden_layer_num + [out_dim]),
        'shape': _fake_shape_gen_sd(rng, cfg.shape),
        'rgb_pred': _fake_mlp_sd(
            rng, 'net', [code] + [rp.hidden_dim] * rp.hidden_layer_num
            + [sum(rp.predict_dict.values())], norm='bn'),
        'curliness_pred': _fake_mlp_sd(
            rng, 'net', [code] + [cp.hidden_dim] * cp.hidden_layer_num
            + [sum(cp.predict_dict.values())], norm='bn'),
    }


def test_converter_copy_equals_jax(tiny_editor):
    cfg = tiny_editor.cfg
    sds = fake_state_dicts(cfg)
    ct = cfg.color_texture
    for name, fn, kw in (
            ('sean', 'convert_sean', dict(ngf=cfg.sean.ngf,
                                          style_dim=cfg.sean.style_dim)),
            ('ct_gen', 'convert_ct_generator', {}),
            ('ct_dis', 'convert_ct_discriminator', {}),
            ('shape', 'convert_shape_generator', dict(
                layer_num=cfg.shape.layer_num, img_size=cfg.shape.img_size,
                hidden_in_channel=cfg.shape.hidden_in_channel,
                max_channel=cfg.shape.max_channel)),
            ('rgb_pred', 'convert_predictor', {}),
            ('curliness_pred', 'convert_predictor', {})):
        sd = ti.strip_ddp_prefix(sds[name])
        assert sd == jti.strip_ddp_prefix(sds[name])
        assert_same_tree(getattr(ti, fn)(sd, **kw),
                         getattr(jti, fn)(sd, **kw))
    # the layout helpers, on torch tensors as the reference stores them
    w = torch.randn(5, 3, 4, 4)
    np.testing.assert_array_equal(ti.conv_transpose_kernel(w),
                                  jti.conv_transpose_kernel(w))
    sd = {'c.weight_orig': torch.randn(6, 4, 3, 3), 'c.weight_u':
          torch.randn(6)}
    np.testing.assert_array_equal(ti.spectral_weight(sd, 'c'),
                                  jti.spectral_weight(sd, 'c'))


def test_load_reference_params(tiny_editor, tmp_path):
    cfg = tiny_editor.cfg
    sds = {k: {n: torch.tensor(v) for n, v in sd.items()}
           for k, sd in fake_state_dicts(cfg, seed=1).items()}
    paths = {}
    for name, payload in (
            ('sean', sds['sean']),
            ('ct', {'Model_G': sds['ct_gen'], 'Model_D': sds['ct_dis']}),
            ('shape', {'Model_G': sds['shape']}),
            ('rgb', {'Predictor': sds['rgb_pred']}),
            ('curliness', sds['curliness_pred'])):   # a bare state dict
        paths[name] = str(tmp_path / f'{name}.pth')
        torch.save(payload, paths[name])
    kw = dict(sean_path=paths['sean'], color_texture_ckpt=paths['ct'],
              shape_ckpt=paths['shape'], rgb_predictor_ckpt=paths['rgb'],
              curliness_predictor_ckpt=paths['curliness'],
              bisenet_path=str(tmp_path / 'absent.pth'))
    jed = copy.copy(tiny_editor)           # the session fixture stays as is
    jparams = jload.load_reference_params(jed, **kw)
    port = HairEditor(port_config(cfg), device='cpu')
    before = {k: v.clone() for k, v in port.state_dict().items()}
    loaded = load_reference_params(port, **kw)
    assert set(loaded) == {'sean', 'ct_gen', 'ct_dis', 'shape', 'rgb_pred',
                           'curliness_pred'}
    want = from_flax(jax.device_get(
        {k: v for k, v in jparams.items() if k in loaded}))
    got = port.state_dict()
    for key, value in want.items():
        torch.testing.assert_close(got[key], value, rtol=0, atol=0,
                                   msg=key)
    for key in got:                         # bisenet was absent: unchanged
        if key.startswith('bisenet.'):
            assert torch.equal(got[key], before[key])


def test_load_reference_params_refuses_a_misfit(tiny_editor, tmp_path):
    """A checkpoint of another width raises, where the JAX editor would
    take the tree and fail later."""
    cfg = tiny_editor.cfg
    wide = dataclasses.replace(cfg.rgb_predictor, hidden_dim=8)
    rng = np.random.default_rng(2)
    sd = _fake_mlp_sd(rng, 'net', [cfg.sean.style_dim, 8, 8, 8, 4],
                      norm='bn')
    path = str(tmp_path / 'rgb.pth')
    torch.save({'Predictor': {k: torch.tensor(v) for k, v in sd.items()}},
               path)
    port = HairEditor(port_config(cfg), device='cpu')
    with pytest.raises(ValueError, match='rgb_pred'):
        load_reference_params(port, rgb_predictor_ckpt=path)
    assert wide.hidden_dim != cfg.rgb_predictor.hidden_dim


def test_ct_modules_load_and_write_flax_trees(tiny_editor):
    """from_flax / to_flax round trip on the training modules, with the
    JAX package's initialisation of each (the latent-prior critic too)."""
    import jax.numpy as jnp
    from ctrlhair_tpu.models import color_texture as jct
    from ctrlhair_tpu_torch.convert import to_flax
    from ctrlhair_tpu_torch.models import color_texture as pct
    from test_torch_trainers import TINY_CT, port_cfg
    data = {'noise': jnp.zeros((2, TINY_CT.noise_dim)),
            'noise_curliness': jnp.zeros((2, 1))}
    ref = jax.device_get(jct.CTDiscriminatorNoise(TINY_CT, train=True).init(
        jax.random.PRNGKey(0), data))
    mod = pct.CTDiscriminatorNoise(port_cfg(TINY_CT), train=True)
    load_variables(mod, 'ct_dis_noise', ref)
    assert_same_tree(to_flax(mod, 'ct_dis_noise'), ref)
    out = jct.CTDiscriminatorNoise(TINY_CT).apply(
        ref, {k: jnp.ones_like(v) * 0.3 for k, v in data.items()})['adv']
    got = mod({k: torch.ones(tuple(v.shape)) * 0.3
               for k, v in data.items()})['adv']
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               rtol=1e-5, atol=1e-6)
    # the SEAN's ConvTranspose is inverted too
    sean_vars = jax.device_get(tiny_editor.params['sean'])
    port = HairEditor(port_config(tiny_editor.cfg), device='cpu')
    load_variables(port.sean, 'sean', sean_vars)
    assert_same_tree(jax.tree_util.tree_map(np.float32, to_flax(
        port.sean, 'sean')), jax.tree_util.tree_map(np.float32, sean_vars))
    # the orthogonal losses, on subspace bases that are not orthogonal
    rng = np.random.default_rng(3)
    gen_vars = jax.device_get(tiny_editor.params['ct_gen'])
    gen_vars = jax.tree_util.tree_map_with_path(
        lambda p, x: rng.standard_normal(x.shape).astype(np.float32)
        if p[-1].key == 'U' else x, gen_vars)
    load_variables(port.ct_gen, 'ct_gen', gen_vars)
    jgen = jct.make_generator(tiny_editor.cfg.color_texture)
    np.testing.assert_allclose(float(port.ct_gen.orthogonal_loss()),
                               float(jgen.orthogonal_loss(gen_vars)),
                               rtol=1e-6)
    u = gen_vars['params']['subspace_0']['U']
    np.testing.assert_allclose(
        float(pct.SubspaceLayer.orthogonal_regularizer(torch.tensor(u))),
        float(jct.SubspaceLayer.orthogonal_regularizer(jnp.asarray(u))),
        rtol=1e-6)


def fake_bisenet_sd(rng, n_classes=19):
    """A reference face-parsing state dict (face_parsing/model.py layout):
    the ResNet-18 context path, both attention-refinement modules, the
    feature fusion, and the main and both auxiliary heads."""
    sd = {}

    def conv(name, cout, cin, k):
        sd[f'{name}.weight'] = (rng.standard_normal((cout, cin, k, k))
                                * 0.1).astype(np.float32)

    def bn(name, c):
        sd[f'{name}.weight'] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        sd[f'{name}.bias'] = rng.standard_normal(c).astype(np.float32)
        sd[f'{name}.running_mean'] = rng.standard_normal(c).astype(
            np.float32)
        sd[f'{name}.running_var'] = rng.uniform(0.5, 2, c).astype(np.float32)
        sd[f'{name}.num_batches_tracked'] = np.asarray(7, np.int64)

    def cbr(name, cin, cout, k):
        conv(f'{name}.conv', cout, cin, k)
        bn(f'{name}.bn', cout)

    conv('cp.resnet.conv1', 64, 3, 7)
    bn('cp.resnet.bn1', 64)
    cin = 64
    for li, (c, stride) in enumerate([(64, 1), (128, 2), (256, 2),
                                      (512, 2)]):
        for j in range(2):
            src = f'cp.resnet.layer{li + 1}.{j}'
            conv(f'{src}.conv1', c, cin, 3)
            bn(f'{src}.bn1', c)
            conv(f'{src}.conv2', c, c, 3)
            bn(f'{src}.bn2', c)
            if j == 0 and (cin != c or stride != 1):
                conv(f'{src}.downsample.0', c, cin, 1)
                bn(f'{src}.downsample.1', c)
            cin = c
    for arm, c in (('cp.arm16', 256), ('cp.arm32', 512)):
        cbr(f'{arm}.conv', c, 128, 3)
        conv(f'{arm}.conv_atten', 128, 128, 1)
        bn(f'{arm}.bn_atten', 128)
    cbr('cp.conv_head32', 128, 128, 3)
    cbr('cp.conv_head16', 128, 128, 3)
    cbr('cp.conv_avg', 512, 128, 1)
    cbr('ffm.convblk', 256, 256, 1)
    conv('ffm.conv1', 64, 256, 1)
    conv('ffm.conv2', 256, 64, 1)
    for head, cin, mid in (('conv_out', 256, 256), ('conv_out16', 128, 64),
                           ('conv_out32', 128, 64)):
        cbr(f'{head}.conv', cin, mid, 3)
        conv(f'{head}.conv_out', n_classes, mid, 1)
    return sd


def test_bisenet_reference_import(tiny_editor, tmp_path):
    """The reference parser's state dict, auxiliary heads included: the
    port's converter equals JAX's convert_bisenet exactly, and
    load_reference_params puts it into the editor's BiSeNet (the heads,
    which the editor does not build, dropped) as JAX's loads it."""
    sd = fake_bisenet_sd(np.random.default_rng(4))
    got = ti.convert_bisenet(sd)
    want = jti.convert_bisenet(sd)
    assert_same_tree(got, want)
    assert {'conv_out16', 'conv_out32'} <= set(got['params'])
    path = str(tmp_path / 'face_parsing_79999_iter.pth')
    torch.save({'module.' + k: torch.tensor(v) for k, v in sd.items()},
               path)
    jed = copy.copy(tiny_editor)
    jparams = jload.load_reference_params(jed, bisenet_path=path)
    port = HairEditor(port_config(tiny_editor.cfg), device='cpu')
    assert load_reference_params(port, bisenet_path=path) == {
        'bisenet': path}
    jb = jax.device_get(jparams['bisenet'])
    wanted = from_flax({'bisenet': {
        col: {k: v for k, v in sub.items()
              if k not in ('conv_out16', 'conv_out32')}
        for col, sub in jb.items()}})
    state = port.state_dict()
    assert set(wanted) == {k for k in state if k.startswith('bisenet.')}
    for key, value in wanted.items():
        torch.testing.assert_close(state[key], value, rtol=0, atol=0,
                                   msg=key)


def test_load_reference_tree(tiny_editor, tmp_path):
    """The reference repository's on-disk layout, built from synthetic
    reference state dicts: load_reference_tree loads into the port's editor
    what JAX's load_reference_tree loads into its own (every family, the
    face parser without its auxiliary heads, the median style codes), and
    what load_reference_params does with the explicit paths.  A branch's
    `latest_checkpoint` manifest wins over a later name; without one the
    last *.ckpt by name is taken; a branch without checkpoints is left as
    it is."""
    cfg = tiny_editor.cfg
    sds = {k: {n: torch.tensor(v) for n, v in sd.items()}
           for k, sd in fake_state_dicts(cfg, seed=5).items()}
    decoys = {k: {n: torch.tensor(v) for n, v in sd.items()}
              for k, sd in fake_state_dicts(cfg, seed=6).items()}
    root = tmp_path / 'reference'
    ext = root / 'external_model_params'
    files = {
        ext / 'sean_checkpoints' / 'CelebA-HQ_pretrained' /
        'latest_net_G.pth': sds['sean'],
        ext / 'face_parsing_79999_iter.pth': {
            'module.' + k: torch.tensor(v) for k, v in
            fake_bisenet_sd(np.random.default_rng(7)).items()}}
    trained = root / 'model_trained'
    ct = trained / 'color_texture' / '045__color_texture_final' / \
        'checkpoints'
    shape = trained / 'shape' / \
        '054__succeed__049__gan_fake_0.5_from_noise' / 'checkpoints'
    rgb = trained / 'color_encoder' / 'p004___pca_std' / 'checkpoints'
    files.update({
        ct / '0000300.ckpt': {'Model_G': sds['ct_gen'],
                              'Model_D': sds['ct_dis']},
        ct / '0000400.ckpt': {'Model_G': decoys['ct_gen'],
                              'Model_D': decoys['ct_dis']},
        shape / '0000100.ckpt': {'Model_G': decoys['shape']},
        shape / '0000200.ckpt': {'Model_G': sds['shape']},
        rgb / 'predictor.ckpt': {'Predictor': sds['rgb_pred']}})
    for path, payload in files.items():
        path.parent.mkdir(parents=True, exist_ok=True)
        torch.save(payload, str(path))
    for d, name in ((ct, '0000300.ckpt'), (rgb, 'predictor.ckpt')):
        (d / 'latest_checkpoint').write_text(name + '\n')
    styles = root / 'sean_codes' / 'styles_test' / 'mean_style_code' / \
        'median'
    rng = np.random.default_rng(8)
    for i in (0, 4, HAIR):
        (styles / str(i)).mkdir(parents=True)
        np.save(str(styles / str(i) / 'ACE.npy'), rng.standard_normal(
            cfg.sean.style_dim).astype(np.float32))

    jed = copy.copy(tiny_editor)           # the session fixture stays as is
    jparams = jax.device_get(jload.load_reference_tree(jed, str(root)))
    port = HairEditor(port_config(cfg), device='cpu')
    before = {k: v.clone() for k, v in port.state_dict().items()}
    loaded = load_reference_tree(port, str(root))
    assert set(loaded) == {'sean', 'bisenet', 'ct_gen', 'ct_dis', 'shape',
                           'rgb_pred'}
    assert loaded['shape'].endswith('0000200.ckpt')
    assert loaded['ct_gen'].endswith('0000300.ckpt')
    jparams['bisenet'] = {
        col: {k: v for k, v in sub.items()
              if k not in ('conv_out16', 'conv_out32')}
        for col, sub in jparams['bisenet'].items()}
    want = from_flax({k: v for k, v in jparams.items()
                      if k in loaded or k == 'style_fallback'})
    got = port.state_dict()
    assert np.abs(want['style_fallback'].numpy()).sum() > 0
    for key, value in want.items():
        torch.testing.assert_close(got[key], value, rtol=0, atol=0,
                                   msg=key)
    for key in got:                   # the curliness branch had no files
        if key.startswith('curliness_pred.'):
            assert torch.equal(got[key], before[key])
    explicit = HairEditor(port_config(cfg), device='cpu')
    assert load_reference_params(
        explicit, sean_path=loaded['sean'], bisenet_path=loaded['bisenet'],
        color_texture_ckpt=loaded['ct_gen'], shape_ckpt=loaded['shape'],
        rgb_predictor_ckpt=loaded['rgb_pred'],
        style_fallback_dir=str(styles)) == loaded
    for key, value in explicit.state_dict().items():
        torch.testing.assert_close(got[key], value, rtol=0, atol=0,
                                   msg=key)
