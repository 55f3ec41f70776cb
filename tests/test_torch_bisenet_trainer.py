# The port's face-parser trainer (ctrlhair_tpu_torch/training/
# bisenet_trainer.py, the auxiliary heads and train mode of models/
# bisenet.py, SGD in training/train_state.py, data/sean_dataset.py) against
# the JAX package's, at BiSeNetConfig(input_size=64, blocks_per_stage=1).
# Both sides start from JAX's state (parameters with both auxiliary heads,
# running statistics, the SGD trace) and take the same batches.  Bars, as
# in tests/test_torch_trainers.py: one step within 1e-5 and three within
# 1e-4 of JAX's, each leaf scaled by its largest magnitude (max(1, |max|)),
# the running statistics included; no exemption is needed (SGD's step is
# linear in the gradient).
#
# Train mode is held with the models computing in float64 on both sides
# (jax.enable_x64 and the flax model's dtype on the JAX side, the model's
# dtype on the port's; parameters, gradients, the trace and the statistics
# stay float32, as in training).  In float32 a train-mode step
# is too ill-conditioned for the bars: the attention maps' BatchNorm
# normalises [N,1,1,C] over the batch alone with flax's E[x^2] - E[x]^2,
# which cancels catastrophically, and two float32 evaluations of the same
# step (XLA:CPU's and torch's) stood 1e-3 of a gradient's scale apart at
# 64 px with a batch of 2, and 2.3e-4 apart on the trace at step 3 at 32 px
# with a batch of 16 (a first step at 32 px with a batch of 8 stood within
# 1e-6).
#
# OHEM's threshold is a discrete choice: the training batches' labels are
# uniform over the 19 classes, so at every step every pixel of every head is
# hard (the true class's probability is far below 0.7), which the test
# checks before each step; the two OHEM branches are also held one by one
# on fixed logits.
import os

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from ctrlhair_tpu.config import BiSeNetConfig as JaxBiSeNetConfig
from ctrlhair_tpu.data.sean_dataset import SEANDataset as JaxSEANDataset
from ctrlhair_tpu.models.bisenet import BiSeNet as JaxBiSeNet
from ctrlhair_tpu.training import bisenet_trainer as jbt
from ctrlhair_tpu.training.train_state import (
    ModelOpt as JaxModelOpt, safe_apply_updates as jax_apply)
from ctrlhair_tpu_torch.config import BiSeNetConfig
from ctrlhair_tpu_torch.convert import load_variables
from ctrlhair_tpu_torch.data.sean_dataset import SEANDataset
from ctrlhair_tpu_torch.models.bisenet import BiSeNet
from ctrlhair_tpu_torch.training import bisenet_trainer as pbt
from ctrlhair_tpu_torch.training.train_state import (
    SGD, SGDModelOpt, batch_stats, grads_finite, safe_apply_updates)
from test_torch_trainers import (
    ONE_STEP, THREE_STEPS, assert_metrics, assert_trees, state_dict,
    to_torch)

SIZE, BATCH = 64, 2
JCFG = JaxBiSeNetConfig(input_size=SIZE, blocks_per_stage=1)
CFG = BiSeNetConfig(input_size=SIZE, blocks_per_stage=1)


def x64():
    return jax.enable_x64(True)


@pytest.fixture(scope='module')
def jax_trainer():
    """JAX's trainer with its model computing in float64."""
    with x64():
        jtr = jbt.BiSeNetTrainer(JCFG)
        jtr.model = JaxBiSeNet(JCFG, train=True, return_aux=True,
                               dtype=jnp.float64)
    return jtr


def bisenet_batch(seed, nan=False):
    rng = np.random.default_rng(seed)
    image = rng.standard_normal((BATCH, SIZE, SIZE, 3)).astype(np.float32)
    if nan:
        image[1, 5, 6, 2] = np.nan
    return {'image': image,
            'label': rng.integers(0, 19, (BATCH, SIZE, SIZE)).astype(
                np.int32)}


def every_pixel_hard(pstate, batch, margin=0.1):
    """Every pixel of every head is above OHEM's threshold by `margin`, on
    the port's train-mode logits before the step (which stand within 1e-5
    of JAX's), so both sides take the threshold branch on all of them."""
    model = pstate.model.module
    saved = {k: b.clone() for k, b in batch_stats(model).items()}
    with torch.no_grad():
        heads = model(torch.tensor(batch['image']))
    for k, b in batch_stats(model).items():
        b.copy_(saved[k])
    label = torch.tensor(batch['label']).long()[..., None]
    for logits in heads:
        per = -torch.gather(torch.log_softmax(logits, -1), -1, label)
        assert bool((per > -np.log(0.7) + margin).all())


def float64_state(ptr):
    """The trainer's state with its model computing in float64 (its
    parameters, gradients and trace float32)."""
    model = BiSeNet(ptr.cfg, dtype=torch.float64, train=True,
                    return_aux=True)
    return pbt.BiSeNetTrainState(step=0,
                                 model=SGDModelOpt(model, ptr.tx, 'bisenet'))


def run(jtr, steps, nan_at=None):
    with x64():
        jstate = jtr.init_state(jax.random.PRNGKey(0))
    ptr = pbt.BiSeNetTrainer(CFG, device='cpu')
    pstate = float64_state(ptr)
    pstate.load_tree(state_dict(jstate))
    assert_trees(pstate.to_tree(), state_dict(jstate), 0)
    for step in range(steps):
        batch = bisenet_batch(20 + step, nan=step == nan_at)
        before = state_dict(jstate)
        if step != nan_at:
            every_pixel_hard(pstate, batch)
        with x64():
            jstate, jm = jtr.train_step(
                jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                jax.random.PRNGKey(step))
        pstate, pm = ptr.train_step(pstate, to_torch(batch))
        yield step, jstate, jm, pstate, pm, before


def test_one_and_three_steps(jax_trainer):
    for step, jstate, jm, pstate, pm, before in run(jax_trainer, 3):
        tol = ONE_STEP if step == 0 else THREE_STEPS
        assert bool(jm['finite']) and bool(pm['finite'])
        assert set(pm) == {'main', 'aux16', 'aux32', 'total', 'finite'}
        assert_metrics(pm, jm, tol)
        got = pstate.to_tree()
        assert_trees(got, state_dict(jstate), tol)
        # the running statistics moved, by flax's rule
        assert not np.allclose(
            got['stats']['resnet']['bn1']['mean'],
            before['stats']['resnet']['bn1']['mean'])


def test_nan_batch_leaves_state(jax_trainer):
    for step, jstate, jm, pstate, pm, before in run(jax_trainer, 2,
                                                    nan_at=1):
        if step == 0:
            mine = pstate.to_tree()
            continue
        assert not bool(jm['finite']) and not bool(pm['finite'])
        after = state_dict(jstate)
        after['step'] = before['step']
        assert_trees(after, before, 0)
        now = pstate.to_tree()
        assert int(now['step']) == 2
        now['step'] = mine['step']
        assert_trees(now, mine, 0)


def test_ohem_both_branches():
    rng = np.random.default_rng(1)
    labels = rng.integers(0, 19, (2, 16, 16)).astype(np.int32)
    labels[0, :3] = 255                                  # ignored pixels
    flat = rng.standard_normal((2, 16, 16, 19)).astype(np.float32)
    confident = flat.copy()
    np.put_along_axis(confident, labels.clip(0, 18)[..., None], 12.0, -1)
    # k = 16 of 256 pixels: at most 12 hard ones per image take the top-k
    # branch
    confident[:, 4, :12] = flat[:, 4, :12]
    for logits, branch in ((flat, 'thresh'), (confident, 'topk')):
        per = -np.take_along_axis(
            np.asarray(jax.nn.log_softmax(logits, -1)),
            labels.clip(0, 18)[..., None], -1)[..., 0]
        per = np.where(labels == 255, 0, per).reshape(2, -1)
        n_hard = (per > -np.log(np.float32(0.7))).sum(1)
        assert ((n_hard > 16) == (branch == 'thresh')).all(), n_hard
        assert (n_hard > 0).all()
        want = jbt.ohem_cross_entropy(jnp.asarray(logits),
                                      jnp.asarray(labels))
        got = pbt.ohem_cross_entropy(torch.tensor(logits),
                                     torch.tensor(labels))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                   atol=1e-6, err_msg=branch)
    all_ignored = np.full_like(labels, 255)
    assert float(pbt.ohem_cross_entropy(torch.tensor(flat),
                                        torch.tensor(all_ignored))) == 0.0


@pytest.mark.parametrize('train', [False, True])
def test_aux_heads_logits_and_batch_stats(train):
    """Inference in float32; train mode (batch statistics) in float64, as
    the steps are held."""
    x = np.random.default_rng(2).standard_normal((2, 64, 64, 3)).astype(
        np.float32)
    with x64():
        model = JaxBiSeNet(JCFG, train=train, return_aux=True,
                           dtype=jnp.float64 if train else jnp.float32)
        variables = jax.device_get(model.init(jax.random.PRNGKey(4),
                                              jnp.asarray(x)))
        want, updated = model.apply(variables, jnp.asarray(x),
                                    mutable=['batch_stats'])
    port = BiSeNet(CFG, train=train, return_aux=True,
                   dtype=torch.float64 if train else torch.float32)
    load_variables(port, 'bisenet', variables)
    got = port(torch.tensor(x))
    assert len(got) == 3
    for g, w in zip(got, want):
        scale = max(1.0, float(np.abs(np.asarray(w)).max()))
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=0, atol=1e-5 * scale)
    from ctrlhair_tpu_torch.convert import to_flax
    stats = to_flax(port, 'bisenet')['batch_stats']
    ref = updated['batch_stats'] if train else variables['batch_stats']
    assert_trees(stats, jax.device_get(ref), 1e-5)
    # the inference model builds no auxiliary heads
    plain = BiSeNet(CFG)
    assert not any(k.startswith(('conv_out16', 'conv_out32'))
                   for k in plain.state_dict())


def test_sgd_matches_optax_over_seven_updates():
    """optax.chain(add_decayed_weights(5e-4), sgd(1e-2, momentum=0.9))
    through the JAX package's safe_apply_updates, one update skipped by a
    non-finite gradient."""
    rng = np.random.default_rng(3)
    module = torch.nn.Linear(5, 3)
    tx = optax.chain(optax.add_decayed_weights(5e-4),
                     optax.sgd(1e-2, momentum=0.9))
    params = {'bias': rng.standard_normal(3).astype(np.float32),
              'weight': rng.standard_normal((3, 5)).astype(np.float32)}
    with torch.no_grad():
        for k, v in params.items():
            getattr(module, k).copy_(torch.tensor(v))
    jopt = JaxModelOpt.create(jax.tree_util.tree_map(jnp.asarray, params),
                              tx)
    popt = SGDModelOpt(module, SGD(1e-2, 0.9, 5e-4), 'm')
    for i in range(7):
        g = {k: rng.standard_normal(v.shape).astype(np.float32) * 3
             for k, v in params.items()}
        if i == 4:
            g['weight'][1, 2] = np.inf
        jg = jax.tree_util.tree_map(jnp.asarray, g)
        jopt = jax_apply(jopt, jg, tx, jnp.all(jnp.stack(
            [jnp.all(jnp.isfinite(v)) for v in jax.tree_util.tree_leaves(
                jg)])))
        tg = [torch.tensor(g[k]) for k, _ in module.named_parameters()]
        safe_apply_updates(popt, tg, grads_finite(tg))
        for k, p in module.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(jopt.params[k]), rtol=0,
                                       atol=1e-6)
            np.testing.assert_allclose(
                popt.trace[k].numpy(),
                np.asarray(jopt.opt_state[1][0].trace[k]), rtol=0,
                atol=1e-6)
    layout = flax.serialization.to_state_dict(jopt.opt_state)
    assert set(layout) == {'0', '1'} and layout['0'] == {} and \
        set(layout['1']) == {'0', '1'} and layout['1']['1'] == {}


def test_sean_dataset_batches_equal_jax(tmp_path):
    rng = np.random.default_rng(5)
    img_dir, lab_dir = tmp_path / 'images', tmp_path / 'labels'
    os.makedirs(img_dir)
    os.makedirs(lab_dir)
    for i in range(5):
        size = 40 if i % 2 else 32                   # some need a resize
        Image.fromarray(rng.integers(0, 256, (size, size, 3),
                                     dtype=np.uint8)).save(
            img_dir / f'{i:03d}.png')
        Image.fromarray(rng.integers(0, 19, (size, size)).astype(np.uint8),
                        'L').save(lab_dir / f'{i:03d}.png')
    Image.fromarray(np.zeros((32, 32, 3), np.uint8)).save(
        img_dir / 'unpaired.png')
    want = JaxSEANDataset(str(img_dir), str(lab_dir), crop_size=32, seed=9)
    got = SEANDataset(str(img_dir), str(lab_dir), crop_size=32, seed=9)
    assert got.names == want.names and len(got) == 5
    for _ in range(3):
        b, a = got.batch(4), want.batch(4)
        for k in ('image', 'label'):
            assert b[k].dtype == a[k].dtype
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    assert SEANDataset(str(tmp_path / 'none'), str(lab_dir)).batch(2) is None


def test_run_bisenet_on_cpu_and_its_refusals(tmp_path, monkeypatch):
    """run_bisenet.main at 32 px on the CPU: synthetic batches for three
    steps write a checkpoint the JAX package restores into its trainer's
    state; paired images and labels are read through SEANDataset; without a
    card and without --device cpu it exits 2; --dp 2 without the
    launcher exits 2."""
    from ctrlhair_tpu.utils import checkpoint as jckpt
    from ctrlhair_tpu_torch.training import run_bisenet
    d = str(tmp_path / 'synthetic')
    common = ['--device', 'cpu', '--batch-size', '2', '--input-size', '32']
    state = run_bisenet.main(['--synthetic', '--steps', '3', '--out-dir', d]
                             + common)
    assert state.step == 3
    target = jbt.BiSeNetTrainer(JaxBiSeNetConfig(input_size=32)).init_state(
        jax.random.PRNGKey(0))
    restored, step = jckpt.load_checkpoint(os.path.join(d, 'checkpoints'),
                                           target)
    assert step == 2 and int(restored.step) == 3
    assert_trees(state_dict(restored), state.to_tree(), 0)
    rng = np.random.default_rng(0)
    for sub in ('images', 'labels'):
        os.makedirs(tmp_path / sub)
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, (40, 40, 3), dtype=np.uint8)
                        ).save(tmp_path / 'images' / f'{i}.png')
        Image.fromarray(rng.integers(0, 19, (40, 40)).astype(np.uint8),
                        'L').save(tmp_path / 'labels' / f'{i}.png')
    state = run_bisenet.main(
        ['--steps', '1', '--image-dir', str(tmp_path / 'images'),
         '--label-dir', str(tmp_path / 'labels'), '--out-dir',
         str(tmp_path / 'paired')] + common)
    assert state.step == 1
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(SystemExit) as e:
        run_bisenet.main(['--synthetic', '--steps', '1', '--out-dir',
                          str(tmp_path / 'none')])
    assert e.value.code == 2
    monkeypatch.delenv('WORLD_SIZE', raising=False)
    with pytest.raises(SystemExit) as e:     # no launcher: no ranks
        run_bisenet.main(['--dp', '2', '--synthetic'])
    assert e.value.code == 2
