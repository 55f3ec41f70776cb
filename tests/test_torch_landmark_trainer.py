# The port's landmark-regressor training (ctrlhair_tpu_torch/data/
# landmark_dataset.py with its cv2-free painter utils/draw.py, training/
# landmark_trainer.py, training/run_landmark.py) against the JAX package's,
# which paints with cv2.
#
# Renderer: for 16 seeds, training_batch (and render_face and background
# alone) give JAX's landmarks and presence exactly; the bar on an image is
# >= 99.5% of its pixels equal, no pixel off by more than the colours that
# meet around it (the range of JAX's image over its 3x3 neighbourhood).
# Measured: every image of every seed equal, pixel for pixel.  The painter's
# parts against cv2 itself: the blur and the ellipse equal it on every case;
# a polygon equals it whenever it stays inside the image, and >= 90% of
# random polygons that cross the border do too (measured 282 of 300:
# OpenCV 5.0 paints a run of the border column for some of them that the
# polygon does not cover).
#
# Trainer: both sides start from JAX's parameters, take JAX's batches
# (rendered by the JAX package), and after one step agree within 1e-5 and
# after three within 1e-4 (the bars of tests/test_torch_trainers.py:
# every loss, parameter, Adam moment and count, each leaf scaled by max(1,
# its largest magnitude)).  One
# exemption, named and counted: the conv bias of every ConvBlock (stem,
# down_i, res_i; 488 entries at the test's config, counted) feeds an
# InstanceNorm, which subtracts any per-channel constant, so its true
# gradient is zero; each side computes rounding noise, and Adam, which
# divides a gradient by its own magnitude, moves it by up to lr either way.
# Those biases are held to: both sides' gradient is noise (|mu| <= 1e-5 of
# the model's largest |mu|) and each step moved them by at most 2 lr on
# both sides; the norm cancels them, so nothing else moves with them.  The
# other entries whose gradient is rounding noise are held as in
# tests/test_torch_shape_trainer.py (assert_trees_noise_exempt), at most
# 0.1% of the trained entries.  After each step the exempted entries take
# JAX's values on the port's side: a difference of lr in one of the head's
# weights otherwise leaks into every later gradient (by up to 1.2e-4 of a
# gradient at step 3, measured).
import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctrlhair_tpu.data import landmark_dataset as JD
from ctrlhair_tpu.models.landmark_net import (
    LandmarkNetConfig as JaxLandmarkNetConfig)
from ctrlhair_tpu.training import landmark_trainer as jlt
from ctrlhair_tpu_torch.data import landmark_dataset as PD
from ctrlhair_tpu_torch.models.landmark_net import LandmarkNetConfig
from ctrlhair_tpu_torch.training import landmark_trainer as plt
from ctrlhair_tpu_torch.utils import draw
from test_torch_trainers import (
    ONE_STEP, THREE_STEPS, assert_metrics, assert_trees,
    assert_trees_noise_exempt, state_dict, to_torch)

PIXELS_EQUAL = 0.995
JCFG = JaxLandmarkNetConfig(input_size=128, base_channels=8, hidden_dim=32)
CFG = LandmarkNetConfig(input_size=128, base_channels=8, hidden_dim=32)


def assert_images(got, want):
    """The image bar of the header; returns the share of equal pixels."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    equal = (got == want).all(-1)
    share = float(equal.mean())
    assert share >= PIXELS_EQUAL
    pad = np.pad(want, ((1, 1), (1, 1), (0, 0)), mode='edge')
    h, w = want.shape[:2]
    win = np.stack([pad[dy:dy + h, dx:dx + w] for dy in range(3)
                    for dx in range(3)])
    assert (np.abs(got - want) <= win.max(0) - win.min(0)).all()
    return share


@pytest.mark.parametrize('seed', range(16))
def test_training_batch_equals_jax(seed):
    want = JD.training_batch(np.random.default_rng(seed), 8, 128)
    got = PD.training_batch(np.random.default_rng(seed), 8, 128)
    for k in ('landmarks', 'presence'):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got['image'].dtype == np.float32
    for g, w in zip(got['image'], want['image']):
        assert_images((g + 1) * 127.5, (w + 1) * 127.5)
    # the renderer's parts alone, on a face and on a background
    rng_j, rng_p = np.random.default_rng(seed), np.random.default_rng(seed)
    lm = JD.transform_landmarks(rng_j)
    np.testing.assert_array_equal(PD.transform_landmarks(rng_p), lm)
    assert_images(PD.render_face(lm, rng_p, 96),
                  JD.render_face(lm, rng_j, 96))
    assert_images(PD.background(rng_p, 64), JD.background(rng_j, 64))
    assert rng_j.uniform() == rng_p.uniform()       # the same draws used


def test_blur_equals_cv2():
    rng = np.random.default_rng(0)
    for shape in ((128, 128, 3), (7, 5, 3), (31, 64), (2, 2, 3)):
        img = rng.integers(0, 256, shape).astype(np.uint8)
        np.testing.assert_array_equal(draw.blur3(img),
                                      cv2.GaussianBlur(img, (3, 3), 0))


def test_ellipses_and_polygons_against_cv2():
    rng = np.random.default_rng(1)
    for _ in range(300):
        c = (int(rng.uniform(0, 128)), int(rng.uniform(0, 128)))
        axes = (int(rng.uniform(1, 60)), int(rng.uniform(1, 60)))
        angle, col = float(rng.uniform(-200, 400)), rng.uniform(0, 255, 3)
        a = np.zeros((128, 128, 3), np.uint8)
        b = a.copy()
        cv2.ellipse(a, c, axes, angle, 0, 360, col.tolist(), -1)
        draw.fill_ellipse(b, c, axes, angle, col.tolist())
        np.testing.assert_array_equal(b, a)
    crossing, equal = 0, 0
    for t in range(600):
        inside = t % 2 == 0
        pts = rng.integers(0 if inside else -40, 128 if inside else 170,
                           (rng.integers(3, 31), 2)).astype(np.int32)
        col = rng.uniform(1, 255, 3)
        a = np.zeros((128, 128, 3), np.uint8)
        b = a.copy()
        cv2.fillPoly(a, [pts.reshape(-1, 1, 2)], col.tolist())
        draw.fill_poly(b, pts, col.tolist())
        if inside:
            np.testing.assert_array_equal(b, a)
        else:
            crossing += 1
            equal += np.array_equal(b, a)
    assert equal >= 0.9 * crossing


@pytest.fixture(scope='module')
def jax_trainer():
    return jlt.LandmarkTrainer(JCFG)


def landmark_batch(seed, nan=False):
    batch = JD.training_batch(np.random.default_rng(seed), 6, 128)
    if nan:
        batch['image'][2, 3, 4, 1] = np.nan
    return batch


def run(jtr, steps, nan_at=None):
    jstate = jtr.init_state(jax.random.PRNGKey(0))
    ptr = plt.LandmarkTrainer(CFG, device='cpu')
    pstate = ptr.init_state()
    pstate.load_tree(state_dict(jstate))
    assert_trees(pstate.to_tree(), state_dict(jstate), 0)
    for step in range(steps):
        batch = landmark_batch(30 + step, nan=step == nan_at)
        before = state_dict(jstate)
        jstate, jm = jtr.train_step(
            jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        pstate, pm = ptr.train_step(pstate, to_torch(batch))
        yield step, jstate, jm, pstate, pm, before, (jtr, ptr, batch)


def normed_biases(cfg):
    return ['stem'] + [f'{k}_{i}' for i in range(cfg.stages)
                       for k in ('down', 'res')]


def zero_normed_biases(got, ref, prev, cfg):
    """Hold the biases in front of an InstanceNorm as the header says, then
    set them to 0 in copies of both trees; returns (got, ref, count)."""
    got = jax.tree_util.tree_map(np.array, got)
    ref = jax.tree_util.tree_map(np.array, ref)
    counted = 0
    for tree in (got, ref):
        mu = tree['model']['opt_state']['0']['mu']['params']
        top = max(np.abs(x).max() for x in jax.tree_util.tree_leaves(mu))
        for name in normed_biases(cfg):
            assert np.abs(mu[name]['conv']['conv']['bias']).max() <= \
                1e-5 * top, name
    for tree, before in ((got, prev[0]), (ref, prev[1])):
        params = tree['model']['params']['params']
        old = before['model']['params']['params']
        for name in normed_biases(cfg):
            b = params[name]['conv']['conv']['bias']
            moved = np.abs(b - old[name]['conv']['conv']['bias'])
            assert moved.max() <= 2 * cfg.lr + 1e-9, name
            counted += b.size
            params[name]['conv']['conv']['bias'] = np.zeros_like(b)
    return got, ref, counted // 2


def test_one_and_three_steps_and_eval(jax_trainer):
    prev, exempt = None, {}
    for step, jstate, jm, pstate, pm, before, (jtr, ptr, batch) in run(
            jax_trainer, 3):
        tol = ONE_STEP if step == 0 else THREE_STEPS
        assert bool(jm['finite']) and bool(pm['finite'])
        assert_metrics(pm, jm, tol)
        prev = prev or (before, before)
        now = (pstate.to_tree(), state_dict(jstate))
        got, ref, normed = zero_normed_biases(*now, prev, CFG)
        assert normed == CFG.base_channels + sum(
            2 * min(CFG.base_channels * 2 ** (i + 1), 256)
            for i in range(CFG.stages))
        noise = assert_trees_noise_exempt(
            got, ref, *prev, {'model': CFG.lr}, CFG.beta1, tol, exempt)
        trained = sum(p.numel() for p in pstate.model.module.parameters())
        assert noise <= 1e-3 * trained
        # the exempted entries take JAX's values, so that their noise does
        # not leak into the later steps
        synced = jax.tree_util.tree_map(np.array, now[0])
        mine = synced['model']['params']
        theirs = now[1]['model']['params']
        for name in normed_biases(CFG):
            mine['params'][name]['conv']['conv']['bias'] = np.array(
                theirs['params'][name]['conv']['conv']['bias'])
        flat, treedef = jax.tree_util.tree_flatten_with_path(mine)
        ref_leaves = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
                      jax.tree_util.tree_flatten_with_path(theirs)[0]}
        synced['model']['params'] = jax.tree_util.tree_unflatten(treedef, [
            np.where(exempt[('model', jax.tree_util.keystr(p))],
                     ref_leaves[jax.tree_util.keystr(p)], v)
            if ('model', jax.tree_util.keystr(p)) in exempt else v
            for p, v in flat])
        pstate.load_tree(synced)
        prev = (synced, now[1])
    # the evaluation, on a state where those biases agree
    pstate.load_tree(state_dict(jstate))
    held = landmark_batch(99)
    jev = jtr.eval_metrics(jstate.model.params,
                           {k: jnp.asarray(v) for k, v in held.items()})
    pev = ptr.eval_metrics(pstate, to_torch(held))
    assert_metrics(pev, jev, THREE_STEPS)


def test_nan_batch_leaves_state(jax_trainer):
    for step, jstate, jm, pstate, pm, before, _ in run(jax_trainer, 2,
                                                       nan_at=1):
        if step == 0:
            mine = pstate.to_tree()
            continue
        assert not bool(jm['finite']) and not bool(pm['finite'])
        after = state_dict(jstate)
        after['step'] = before['step']
        assert_trees(after, before, 0)
        now = pstate.to_tree()
        now['step'] = mine['step']
        assert_trees(now, mine, 0)


def test_smooth_l1_and_bce():
    x = np.linspace(-0.1, 0.1, 41, dtype=np.float32)
    np.testing.assert_allclose(plt.smooth_l1(torch.tensor(x)).numpy(),
                               np.asarray(jlt.smooth_l1(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-9)
    import optax
    logits = np.linspace(-30, 30, 61, dtype=np.float32)
    labels = (np.arange(61) % 2).astype(np.float32)
    np.testing.assert_allclose(
        plt.sigmoid_bce(torch.tensor(logits), torch.tensor(labels)).numpy(),
        np.asarray(optax.sigmoid_binary_cross_entropy(
            jnp.asarray(logits), jnp.asarray(labels))), rtol=1e-6,
        atol=1e-6)


def test_run_landmark_on_cpu_writes_what_the_loader_reads(tmp_path,
                                                           monkeypatch):
    """run_landmark.main on the CPU: a pool of 256, three steps, the held-
    out metrics, and a checkpoint that ops/landmarks.load_landmark_net
    loads and predicts finite points with; without a card and without
    --device cpu it exits 2."""
    from ctrlhair_tpu_torch.ops import landmarks
    from ctrlhair_tpu_torch.training import run_landmark
    out = str(tmp_path / 'ckpt')
    state, metrics, ev = run_landmark.main(
        ['--steps', '3', '--pool', '256', '--batch-size', '8', '--device',
         'cpu', '--out-dir', out])
    assert state.step == 3 and bool(metrics['finite'])
    assert set(ev) == {'test/mean_dist_norm', 'test/mean_dist_px',
                       'test/presence_accuracy'}
    try:
        assert landmarks.load_landmark_net(out, device='cpu')
        img = ((PD.render_face(PD.transform_landmarks(
            np.random.default_rng(0)), np.random.default_rng(1), 256))
            .astype(np.uint8))
        got = landmarks.net_landmarks_81(img, min_presence=0.0,
                                         device='cpu')
        assert got is not None and np.isfinite(got[0]).all() and \
            got[0].shape == (81, 2)
        model = landmarks._NET[0]
        for k, v in model.state_dict().items():
            want = dict(state.model.module.state_dict())[k]
            np.testing.assert_array_equal(v.numpy(), want.numpy())
    finally:
        landmarks.unload_landmark_net()
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(SystemExit) as e:
        run_landmark.main(['--steps', '1', '--out-dir', str(tmp_path / 'x')])
    assert e.value.code == 2
