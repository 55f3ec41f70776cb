# The port's SEAN trainer (ctrlhair_tpu_torch/training/sean_trainer.py,
# run_sean.py, models/sean_discriminator.py, spectral normalisation in
# models/layers.py, train mode and ACE noise in models/sean.py) against the
# JAX package's.  The JAX trainer is built once for the module at a tiny
# config with every feature on (spectral norm, syncbatch, ACE noise, the
# VGG19 term, lambda_l1 > 0, a two-scale discriminator of two layers):
# crop 32, num_up_layers 4 (so the first block's batch statistics run over
# 2x2 maps: at 1x1 a batch of two normalises to +-1 and its gradients are
# rounding noise), one middle block.  The port loads JAX's initial state
# and VGG19 weights, takes the same batches and JAX's ACE noise (the key
# chain of models/sean.ace_noise_shapes), and every leaf of the state
# (parameters, both Adam moments and counts, gen_stats, sn_u, dis_sn_u)
# and every metric agrees within 1e-5 after one step and 1e-4 after three,
# each leaf scaled by max(1, its largest magnitude), in float32.  The
# initial noise_var is drawn non-zero on both sides so that the noise
# counts from the first step.
#
# One exemption, as in tests/test_torch_trainers.py and counted: a conv
# bias in front of a normalisation (every generator conv whose output
# reaches a syncbatch norm before anything else, the discriminator's
# layers in front of their instance norm) has a gradient of exactly zero,
# so each side's is rounding noise, which Adam (beta1 0 here) turns into a
# step of +-lr; those entries are held to "moved at most 2 lr a step"
# (assert_trees_noise_exempt), and so are the entries of a kernel whose
# gradient is too small (1e-5 of its leaf's largest) for the two sides to
# share its sign.  A noise bias's whole leaf is noise, so an entry also
# counts as noise against the largest gradient of its model
# (`noise_entries`).  At most 1% of the trained entries are exempt (the
# count is checked).  The running means downstream absorb 0.1 of such a
# difference a step, which stays inside the bar.
import os

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctrlhair_tpu.config import SEANConfig as JaxSEANConfig
from ctrlhair_tpu.models import layers as jlayers
from ctrlhair_tpu.models import sean_discriminator as jsd
from ctrlhair_tpu.training.sean_trainer import SEANTrainer as JaxSEANTrainer
from ctrlhair_tpu.utils import checkpoint as jckpt
from ctrlhair_tpu_torch.convert import load_variables
from ctrlhair_tpu_torch.models import sean_discriminator as tsd
from ctrlhair_tpu_torch.models.layers import spectral_normalize_tree
from ctrlhair_tpu_torch.models.sean import ace_noise_shapes
from ctrlhair_tpu_torch.training.sean_trainer import (
    SEANTrainer, load_vgg, sn_names)
from ctrlhair_tpu_torch.utils import checkpoint as ckpt
from test_torch_trainers import (
    ONE_STEP, THREE_STEPS, assert_metrics, assert_trees,
    assert_trees_noise_exempt, port_cfg, state_dict)
from test_torch_convert import one_torch_thread  # noqa: F401 (autouse)

TINY = JaxSEANConfig(crop_size=32, ngf=2, zencoder_ngf=2, style_dim=8,
                     num_up_layers=4, num_middle_blocks=1,
                     use_ace_noise=True)
DIS = dict(dis_ndf=4, dis_n_layers=2)
LAMBDA_L1 = 0.5
LRS = {'gen': 1e-4, 'dis': 4e-4}
BATCH = 2


def jax_trainer(cfg=TINY):
    return JaxSEANTrainer(cfg, use_vgg=True, lambda_l1=LAMBDA_L1, **DIS)


def port_trainer(cfg=TINY):
    return SEANTrainer(port_cfg(cfg), use_vgg=True, lambda_l1=LAMBDA_L1,
                       device='cpu', **DIS)


def sean_batch(seed, nan=False):
    rng = np.random.default_rng(seed)
    s = TINY.crop_size
    image = np.tanh(rng.standard_normal((BATCH, s, s, 3))).astype(np.float32)
    if nan:
        image[1, 3, 4, 0] = np.nan
    return {'image': image,
            'label': rng.integers(0, 19, (BATCH, s, s)).astype(np.int32)}


def jax_noise(rng, cfg, n):
    """The ACE noise JAX's decode draws from `rng`, in the port's layout:
    the generator splits once per block, a block once per ACE."""
    shapes = ace_noise_shapes(port_cfg(cfg), n)
    blocks = list(dict.fromkeys(k.split('.')[0] for k in shapes))
    out = {}
    for block in blocks:
        rng, sub = jax.random.split(rng)
        for name in (k for k in shapes if k.split('.')[0] == block):
            sub, key = jax.random.split(sub)
            _, _, h, w = shapes[name]
            draw = jax.random.normal(key, (n, h, w, 1), jnp.float32)
            out[name] = torch.tensor(np.asarray(draw)).permute(0, 3, 1, 2)
    return out


def with_noise_var(jstate, seed=3):
    """The state with every ACE's noise_var drawn from N(0, 0.5^2)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        if jax.tree_util.keystr(path).endswith("['noise_var']"):
            return jnp.asarray(rng.normal(0, 0.5, leaf.shape), jnp.float32)
        return leaf
    params = jax.tree_util.tree_map_with_path(draw, jstate.gen.params)
    return jstate.replace(gen=jstate.gen.replace(params=params))


@pytest.fixture(scope='module')
def run():
    """Three steps and a NaN batch on both sides from JAX's initial state:
    [(JAX state dict, JAX metrics, port tree, port metrics)] after each,
    the initial trees first (metrics None)."""
    jtr = jax_trainer()
    key = jax.random.PRNGKey(0)
    jtr.vgg_params = jax.jit(jtr.vgg.init)(
        key, jnp.zeros((1, TINY.crop_size, TINY.crop_size, 3)))
    jstate = with_noise_var(jax.jit(jtr.init_state)(key))
    ptr = port_trainer()
    pstate = ptr.init_state()
    load_vgg(ptr.vgg, jax.device_get(jtr.vgg_params))
    pstate.load_tree(state_dict(jstate))
    out = [(state_dict(jstate), None, pstate.to_tree(), None)]
    for step in range(4):
        batch = sean_batch(30 + step, nan=step == 3)
        rng = jax.random.PRNGKey(100 + step)
        jstate, jm = jtr.train_step(
            jstate, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
        pstate, pm = ptr.train_step(
            pstate, {k: torch.tensor(v) for k, v in batch.items()},
            jax_noise(rng, TINY, BATCH))
        out.append((state_dict(jstate), jax.device_get(jm), pstate.to_tree(),
                    pm))
    return {'steps': out, 'jtr': jtr, 'ptr': ptr, 'jstate': jstate,
            'pstate': pstate}


def noise_entries(got, ref, exempt):
    """Add to `exempt` the entries whose gradient this step (Adam's first
    moment: beta1 is 0) is below 1e-5 of the largest of its model on JAX's
    side and not reproduced by the port to 1%."""
    for part in LRS:
        g_got, g_ref = ({jax.tree_util.keystr(p): np.asarray(v) for p, v in
                         jax.tree_util.tree_flatten_with_path(
                             t[part]['opt_state']['0']['mu'])[0]}
                        for t in (got, ref))
        scale = max(np.abs(v).max() for v in g_ref.values())
        for k, g in g_ref.items():
            mask = (np.abs(g) <= 1e-5 * scale) & (
                np.abs(g_got[k] - g) > 1e-2 * np.abs(g))
            if mask.any():
                exempt[(part, k)] = exempt.get((part, k), False) | mask


def test_one_and_three_steps(run):
    steps = run['steps']
    exempt = {}
    for i in (1, 2, 3):
        jt, jm, pt, pm = steps[i]
        tol = ONE_STEP if i == 1 else THREE_STEPS
        assert bool(jm['finite']) and bool(pm['finite'])
        assert set(pm) == {'g_total', 'g_finite', 'g/adv', 'g/feat', 'g/l1',
                           'g/vgg', 'd_total', 'finite'}
        assert_metrics(pm, jm, tol)
        noise_entries(pt, jt, exempt)
        n = assert_trees_noise_exempt(pt, jt, steps[i - 1][2],
                                      steps[i - 1][0], LRS, 0.0, tol, exempt)
        # few entries: the noise biases, and kernel entries whose gradient
        # is too small for its sign to be shared (Adam's first step moves
        # every entry by lr times that sign)
        total = sum(np.size(v) for part in LRS for v in
                    jax.tree_util.tree_leaves(jt[part]['params']))
        assert n <= 0.01 * total, (n, total)
    # the u vectors and the running statistics moved
    for key in ('sn_u', 'dis_sn_u', 'gen_stats'):
        a = jax.tree_util.tree_leaves(steps[0][2][key])
        b = jax.tree_util.tree_leaves(steps[3][2][key])
        assert any(not np.array_equal(x, y) for x, y in zip(a, b)), key


def test_nan_batch_leaves_the_weights(run):
    """A NaN batch: no parameter, moment, count or running statistic moves
    on either side; the step counts and the u vectors take their power
    iteration from the unchanged weights (JAX's rule), as JAX's do."""
    jt0, _, pt0, _ = run['steps'][3]
    jt, jm, pt, pm = run['steps'][4]
    assert not bool(jm['finite']) and not bool(pm['finite'])
    assert not bool(jm['g_finite']) and not bool(pm['g_finite'])
    for before, after in ((jt0, jt), (pt0, pt)):
        for key in ('gen', 'dis', 'gen_stats'):
            assert_trees(after[key], before[key], 0)
        assert int(after['step']) == int(before['step']) + 1
    for key in ('sn_u', 'dis_sn_u'):
        assert_trees(pt[key], jt[key], THREE_STEPS)
        assert any(not np.array_equal(x, y) for x, y in zip(
            jax.tree_util.tree_leaves(pt[key]),
            jax.tree_util.tree_leaves(pt0[key])))


def test_sn_templates_match_jax(run):
    """The weights the port normalises are JAX's template, by path."""
    jt = run['steps'][0][0]
    for key, module, layers in (
            ('sn_u', run['pstate'].gen.module, ('conv_0', 'conv_1',
                                                'conv_s')),
            ('dis_sn_u', run['pstate'].dis.module, None)):
        paths = {'.'.join(str(p.key) for p in path[:-1]) + '.weight'
                 for path, _ in jax.tree_util.tree_flatten_with_path(
                     jt[key])[0]}
        assert paths == set(sn_names(module, layers)), key
        assert len(paths) > 0


def test_remat_blocks_equal_gradients(run):
    """cfg.remat_blocks recomputes each block in the backward: the same
    step, bit for bit (port only; no second JAX step is compiled)."""
    import dataclasses
    start = run['steps'][0][0]
    batch = {k: torch.tensor(v) for k, v in sean_batch(30).items()}
    noise = jax_noise(jax.random.PRNGKey(100), TINY, BATCH)
    trees = []
    for remat in (False, True):
        ptr = port_trainer(dataclasses.replace(TINY, remat_blocks=remat))
        pstate = ptr.init_state()
        ptr.vgg.load_state_dict(run['ptr'].vgg.state_dict())
        pstate.load_tree(start)
        pstate, _ = ptr.train_step(pstate, batch, noise)
        trees.append(pstate.to_tree())
    assert_trees(trees[1], trees[0], 0)
    assert_trees(trees[0], run['steps'][1][2], 0)


def test_checkpoints_cross_both_ways(run, tmp_path):
    jstate, pstate = run['jstate'], run['pstate']
    tree = pstate.to_tree()
    ckpt.save_checkpoint(str(tmp_path / 'port'), tree, 4)
    restored, step = jckpt.load_checkpoint(str(tmp_path / 'port'), jstate)
    assert step == 4
    assert_trees(state_dict(restored), tree, 0)
    jckpt.save_checkpoint(str(tmp_path / 'jax'), jstate, 4)
    back, step = ckpt.load_checkpoint(str(tmp_path / 'jax'))
    ptr = port_trainer()
    other = ptr.init_state(seed=9)
    other.load_tree(back)
    assert_trees(other.to_tree(), state_dict(jstate), 0)
    # a tree whose u vectors cover other weights is refused
    bad = dict(back, dis_sn_u=back['sn_u'])
    with pytest.raises((ValueError, KeyError)):
        ptr.init_state().load_tree(bad)


def test_spectral_normalize_values_and_gradients():
    """The port's spectral normalisation against JAX's on a conv kernel
    (OIHW against HWIO: the same [kh*kw*in, out] matrix) and a Dense
    kernel: weights, new u and the gradient of a scalar through v, u and
    sigma; computing u and v without a gradient, as torch's spectral_norm
    does, gives another gradient."""
    rng = np.random.default_rng(0)
    conv = rng.standard_normal((6, 5, 3, 3)).astype(np.float32)   # OIHW
    dense = rng.standard_normal((4, 7)).astype(np.float32)         # [out,in]
    u = {'c': rng.standard_normal(5 * 9).astype(np.float32),
         'd': rng.standard_normal(7).astype(np.float32)}
    u = {k: v / np.linalg.norm(v) for k, v in u.items()}
    probe = {'c': rng.standard_normal(conv.shape).astype(np.float32),
             'd': rng.standard_normal(dense.shape).astype(np.float32)}
    jparams = {'c': {'kernel': conv.transpose(2, 3, 1, 0)},
               'd': {'kernel': dense.T}}
    jprobe = {'c': probe['c'].transpose(2, 3, 1, 0), 'd': probe['d'].T}

    def jloss(params):
        out, new_u = jlayers.spectral_normalize_tree(
            params, {'c': {'kernel': u['c']}, 'd': {'kernel': u['d']}})
        return sum(jnp.sum(out[k]['kernel'] * jprobe[k]) for k in out), \
            (out, new_u)
    (_, (jout, ju)), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, jparams))
    w = {'c': torch.tensor(conv, requires_grad=True),
         'd': torch.tensor(dense, requires_grad=True)}
    out, new_u = spectral_normalize_tree(
        w, {k: torch.tensor(v) for k, v in u.items()})
    loss = sum(torch.sum(out[k] * torch.tensor(probe[k])) for k in out)
    grads = torch.autograd.grad(loss, [w['c'], w['d']])
    for k, layout in (('c', (3, 2, 0, 1)), ('d', (1, 0))):
        np.testing.assert_allclose(
            out[k].detach().numpy(),
            np.asarray(jout[k]['kernel']).transpose(layout), atol=1e-6)
        np.testing.assert_allclose(new_u[k].numpy(),
                                   np.asarray(ju[k]['kernel']), atol=1e-6)
        assert not new_u[k].requires_grad
    np.testing.assert_allclose(
        grads[0].numpy(),
        np.asarray(jgrad['c']['kernel']).transpose(3, 2, 0, 1), atol=1e-6)
    np.testing.assert_allclose(grads[1].numpy(),
                               np.asarray(jgrad['d']['kernel']).T, atol=1e-6)
    # u and v as constants: another gradient
    mat = w['c'].permute(2, 3, 1, 0).reshape(-1, 6)
    with torch.no_grad():
        v = mat.t() @ torch.tensor(u['c'])
        v = v / (v.norm() + 1e-12)
        u1 = mat @ v
        u1 = u1 / (u1.norm() + 1e-12)
    frozen = torch.sum(w['c'] / (u1 @ (mat @ v)) * torch.tensor(probe['c']))
    g_frozen = torch.autograd.grad(frozen, w['c'])[0]
    assert np.abs(g_frozen.numpy() - grads[0].numpy()).max() > 1e-4


def test_discriminator_and_vgg19_match_jax():
    """The multiscale PatchGAN and the five VGG19 slices on the same
    weights; vgg_preprocess; convert_vgg19 of a torchvision-layout state
    dict equal to JAX's conversion."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 40, 40, 22)).astype(np.float32)
    jd = jsd.MultiscaleDiscriminator(num_d=2, ndf=4, n_layers=3)
    dvars = jax.jit(jd.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    ref = jax.jit(jd.apply)(dvars, jnp.asarray(x))
    pd = tsd.MultiscaleDiscriminator(num_d=2, ndf=4, n_layers=3)
    load_variables(pd, 'sean_dis', jax.device_get(dvars))
    got = pd(torch.tensor(x).permute(0, 3, 1, 2))
    for gs, rs in zip(got, ref):
        assert len(gs) == len(rs) == 4
        for g, r in zip(gs, rs):
            r = np.asarray(r).transpose(0, 3, 1, 2)
            np.testing.assert_allclose(g.detach().numpy(), r, rtol=0,
                                       atol=1e-5 * max(1, np.abs(r).max()))
    img = np.tanh(rng.standard_normal((1, 32, 32, 3))).astype(np.float32)
    pre = tsd.vgg_preprocess(torch.tensor(img))
    jpre = jsd.vgg_preprocess(jnp.asarray(img))
    np.testing.assert_allclose(pre.numpy(),
                               np.asarray(jpre).transpose(0, 3, 1, 2),
                               atol=1e-6)
    jv = jsd.VGG19Features()
    vvars = jax.jit(jv.init)(jax.random.PRNGKey(1), jpre)
    ref = jax.jit(jv.apply)(vvars, jpre)
    pv = tsd.VGG19Features()
    load_vgg(pv, jax.device_get(vvars))
    got = pv(pre)
    assert [tuple(g.shape) for g in got] == [
        (1, 64, 32, 32), (1, 128, 16, 16), (1, 256, 8, 8), (1, 512, 4, 4),
        (1, 512, 2, 2)]
    for g, r in zip(got, ref):
        r = np.asarray(r).transpose(0, 3, 1, 2)
        np.testing.assert_allclose(g.detach().numpy(), r, rtol=0,
                                   atol=1e-5 * max(1, np.abs(r).max()))
    # a torchvision vgg19().features state dict, every layer of it
    sd, cin, idx = {}, 3, 0
    for v in jsd._VGG19_CFG:
        if v == 'M':
            idx += 1
            continue
        sd[f'{idx}.weight'] = torch.tensor(
            rng.standard_normal((v, cin, 3, 3)).astype(np.float32))
        sd[f'{idx}.bias'] = torch.tensor(
            rng.standard_normal(v).astype(np.float32))
        cin, idx = v, idx + 2
    pv.load_state_dict(tsd.convert_vgg19(sd), strict=True)
    ref = tsd.VGG19Features()
    load_vgg(ref, jax.tree_util.tree_map(np.asarray, jsd.convert_vgg19(sd)))
    for k, v in ref.state_dict().items():
        torch.testing.assert_close(pv.state_dict()[k], v, rtol=0, atol=0)


def test_run_sean_on_cpu_and_its_refusals(tmp_path, monkeypatch):
    """python -m ctrlhair_tpu_torch.training.run_sean on synthetic batches:
    three steps on the CPU write a checkpoint the JAX package restores into
    its own trainer's state and the port reads back equal; without a card
    and without --device cpu it exits 2; --dp 2 without the
    launcher exits 2."""
    from ctrlhair_tpu_torch.training import run_sean
    d = str(tmp_path / 'sean')
    args = ['--synthetic', '--steps', '3', '--crop-size', '32', '--ngf',
            '2', '--batch-size', '2', '--out-dir', d]
    state = run_sean.main(args + ['--device', 'cpu'])
    assert state.step == 3
    tree, step = ckpt.load_checkpoint(os.path.join(d, 'checkpoints'))
    assert step == 2
    assert_trees(tree, state.to_tree(), 0)
    jcfg = JaxSEANConfig(crop_size=32, ngf=2, zencoder_ngf=2, style_dim=16)
    target = jax.eval_shape(
        lambda: JaxSEANTrainer(jcfg).init_state(jax.random.PRNGKey(0)))
    restored, step = jckpt.load_checkpoint(os.path.join(d, 'checkpoints'),
                                           target)
    assert step == 2
    assert_trees(flax.serialization.to_state_dict(restored),
                 state.to_tree(), 0)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(SystemExit) as e:
        run_sean.main(args)
    assert e.value.code == 2
    monkeypatch.delenv('WORLD_SIZE', raising=False)
    with pytest.raises(SystemExit) as e:     # no launcher: no ranks
        run_sean.main(['--dp', '2', '--synthetic'])
    assert e.value.code == 2


def test_float64_step_on_1x1_maps():
    """With the models computing in float64 and the generator starting
    from 1x1 maps (crop 32, num_up_layers 5), the SEAN step runs on the CPU
    (torch's float64 convolution refused the weight gradient of the folded
    style convolution there: its one-hot input, a view whose strides read
    as channels-last) and equals the same step through the unfolded style
    convolutions, within 1e-10 of each leaf's scale, metrics too."""
    import dataclasses
    from ctrlhair_tpu_torch.models.layers import set_compute_dtype
    cfg = dataclasses.replace(TINY, num_up_layers=5, use_ace_noise=False)
    batch = {k: torch.tensor(v) for k, v in sean_batch(40).items()}
    trees, metrics = [], []
    for fold in (True, False):
        tr = SEANTrainer(port_cfg(dataclasses.replace(
            cfg, fold_style_convs=fold)), use_vgg=False, device='cpu', **DIS)
        state = tr.init_state(5)
        assert tr.cfg.start_size == 1
        for part in state.parts().values():
            set_compute_dtype(part.module, torch.float64)
        state, m = tr.train_step(state, batch)
        assert bool(m['finite'])
        trees.append(state.to_tree())
        metrics.append({k: float(v) for k, v in m.items() if v.numel() == 1})
    assert_metrics(metrics[0], metrics[1], 1e-10)
    assert_trees(trees[0], trees[1], 1e-10)
