# The port's ChunkRunner (ctrlhair_tpu_torch/training/chunked.py) against
# JAX's (ctrlhair_tpu/training/chunked.py) and against the port's own
# per-step loop, on the CPU, where the runner takes its steps eagerly.
#
# Against JAX: JAX's ShapeTrainer at TINY_SHAPE (tests/test_training.py),
# built once for the module, and the port's from the same state; both
# runners take 3 steps in chunks of 2 from the same per-step streams (the
# batch of step s from PRNGKey(batch_seed + s), its draws from
# PRNGKey(step_seed + s); the port is handed the batch and the draws JAX
# makes from them, through numpy).  Bars: on_chunk sees [2, 3] on both
# sides, no trips, rows at the same steps, every recorded loss within 1e-4
# of JAX's and the state within the trainers' three-step bar (1e-4 of each
# leaf's scale; the entries whose gradient is rounding noise held to "moved
# at most 2 lr" and counted, as tests/test_torch_shape_trainer.py holds
# them).
#
# Against itself, bit for bit: the chunked run against the per-step loop
# (7 steps in chunks of 3, the remainder chunk included), a run resumed
# after step 4 against the straight run (as JAX's
# test_chunked_loop_resume_matches_straight_run), a NaN batch inside a
# chunk (one trip, the state that of the per-step loop that skipped it),
# on_chunk's early stop, and the landmark trainer, whose step takes no
# draws.
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from ctrlhair_tpu.training import shape_trainer as jst
from ctrlhair_tpu.training.chunked import ChunkRunner as JaxChunkRunner
from ctrlhair_tpu_torch.models.landmark_net import LandmarkNetConfig
from ctrlhair_tpu_torch.training import chunked
from ctrlhair_tpu_torch.training import losses as L
from ctrlhair_tpu_torch.training import shape_trainer as pst
from ctrlhair_tpu_torch.training.chunked import ChunkRunner
from ctrlhair_tpu_torch.training.landmark_trainer import LandmarkTrainer
from test_torch_shape_trainer import jax_draws
from test_torch_trainers import (
    THREE_STEPS, assert_trees, port_cfg, state_dict, to_torch)
from test_training import TINY_SHAPE

BATCH = 2
BATCH_SEED, STEP_SEED = 2_000_000, 300


@pytest.fixture(scope='module')
def jax_trainer():
    return jst.ShapeTrainer(TINY_SHAPE)


def jax_batch(key):
    return jst.synthetic_batch(key, TINY_SHAPE, BATCH)


def test_chunked_against_jax(jax_trainer):
    cfg = TINY_SHAPE
    jstate = jax_trainer.init_state(jax.random.PRNGKey(0))
    init = state_dict(jstate)
    jseen, pseen = [], []
    jrunner = JaxChunkRunner(jax_trainer._train_step, jax_batch,
                             batch_seed=BATCH_SEED, step_seed=STEP_SEED)
    jstate, jrows, jtrips = jrunner.run(
        jstate, 0, 3, chunk_size=2, record_every=2,
        on_chunk=lambda s, st, rows: jseen.append(s))

    ptr = pst.ShapeTrainer(port_cfg(cfg), device='cpu')
    pstate = ptr.init_state()
    pstate.load_tree(init)

    def make_batch(seed):
        return to_torch({k: np.asarray(v) for k, v in
                         jax_batch(jax.random.PRNGKey(seed)).items()})

    def make_draws(seed):
        return jax_draws(jax.random.PRNGKey(seed), cfg,
                         {'target': np.empty((BATCH,))})

    runner = ChunkRunner(ptr.train_step, make_batch, make_draws=make_draws,
                         batch_seed=BATCH_SEED, step_seed=STEP_SEED)
    pstate, prows, ptrips = runner.run(
        pstate, 0, 3, chunk_size=2, record_every=2,
        on_chunk=lambda s, st, rows: pseen.append(s))

    assert jseen == pseen == [2, 3]
    assert jtrips == ptrips == 0
    assert pstate.step == int(np.asarray(jstate.step)) == 3
    assert [r['step'] for r in prows] == [r['step'] for r in jrows] == [0, 2]
    for pr, jr in zip(prows, jrows):
        assert set(pr) == set(jr)
        for k, v in jr.items():
            assert abs(pr[k] - v) <= THREE_STEPS * max(1.0, abs(v)), k
    assert_trees(pstate.to_tree(), state_dict(jstate), THREE_STEPS)


# ------------------------------------------------- the port against itself
PORT_SHAPE = port_cfg(TINY_SHAPE)


def port_shape(seed_offset=0, nan_at=None):
    """(trainer, state, make_batch, make_draws) of the port's tiny shape
    trainer; make_batch(seed) holds a NaN in the face mask at the step
    nan_at."""
    tr = pst.ShapeTrainer(PORT_SHAPE, device='cpu', seed=5)
    state = tr.init_state(seed_offset)

    def make_batch(seed):
        batch = pst.synthetic_batch(torch.Generator().manual_seed(seed),
                                    PORT_SHAPE, BATCH)
        if nan_at is not None and seed == BATCH_SEED + nan_at:
            batch['face'][1, 3, 4, 0] = float('nan')
        return batch

    return tr, state, make_batch, lambda seed: tr.draws(seed, BATCH)


def per_step(tr, state, make_batch, make_draws, start, stop,
             record_every):
    rows = []
    for s in range(start, stop):
        state, m = tr.train_step(state, make_batch(BATCH_SEED + s),
                                 make_draws(STEP_SEED + s))
        if s % record_every == 0 or s == stop - 1:
            rows.append({'step': s, **{k: float(v) for k, v in m.items()}})
    return state, rows


def runner_of(tr, make_batch, make_draws):
    return ChunkRunner(tr.train_step, make_batch, make_draws=make_draws,
                       batch_seed=BATCH_SEED, step_seed=STEP_SEED)


@pytest.mark.parametrize('nan_at', [None, 4])
def test_chunked_equals_per_step(nan_at):
    """7 steps in chunks of 3 (a remainder of 1) against the per-step loop,
    bit for bit; with nan_at, the NaN batch inside the second chunk is one
    trip and the state skipped it as the per-step loop's did."""
    tr, ref, make_batch, make_draws = port_shape(nan_at=nan_at)
    ref, ref_rows = per_step(tr, ref, make_batch, make_draws, 0, 7, 2)
    tr, state, make_batch, make_draws = port_shape(nan_at=nan_at)
    seen = []
    state, rows, trips = runner_of(tr, make_batch, make_draws).run(
        state, 0, 7, chunk_size=3, record_every=2,
        on_chunk=lambda s, st, rws: seen.append(s))
    assert seen == [3, 6, 7]
    assert trips == (0 if nan_at is None else 1)
    assert state.step == 7
    assert [sorted(r) for r in rows] == [sorted(r) for r in ref_rows]
    np.testing.assert_array_equal(    # NaN where the per-step loop had one
        [[r[k] for k in sorted(r)] for r in rows],
        [[r[k] for k in sorted(r)] for r in ref_rows])
    assert [r['step'] for r in rows] == [0, 2, 4, 6]
    if nan_at is not None:
        assert [r['finite'] for r in rows] == [1.0, 1.0, 0.0, 1.0]
    assert_trees(state.to_tree(), ref.to_tree(), 0)


def test_chunked_resume_equals_straight_run():
    """0..4 in one chunk then 4..6 resumed equals 0..6 in chunks of 2."""
    tr, straight, make_batch, make_draws = port_shape()
    straight, _, _ = runner_of(tr, make_batch, make_draws).run(
        straight, 0, 6, chunk_size=2)
    tr, state, make_batch, make_draws = port_shape()
    runner = runner_of(tr, make_batch, make_draws)
    state, _, _ = runner.run(state, 0, 4, chunk_size=4)
    state, _, _ = runner.run(state, 4, 6, chunk_size=4)
    assert_trees(state.to_tree(), straight.to_tree(), 0)


def test_chunked_early_stop_resumes_exactly():
    """on_chunk's truthy return stops the run after that chunk; the state
    it returns resumes to the straight run's end."""
    tr, straight, make_batch, make_draws = port_shape()
    straight, _ = per_step(tr, straight, make_batch, make_draws, 0, 5, 1)
    tr, state, make_batch, make_draws = port_shape()
    runner = runner_of(tr, make_batch, make_draws)
    seen = []
    state, rows, _ = runner.run(
        state, 0, 5, chunk_size=2, record_every=1,
        on_chunk=lambda s, st, rws: seen.append(s) or s >= 2)
    assert seen == [2] and state.step == 2
    assert [r['step'] for r in rows] == [0, 1]
    state, rows, _ = runner.run(state, 2, 5, chunk_size=2, record_every=1)
    assert [r['step'] for r in rows] == [2, 3, 4]
    assert_trees(state.to_tree(), straight.to_tree(), 0)


def test_chunked_landmark_takes_no_draws():
    """A step that draws nothing (make_draws None): 5 steps in chunks of 2
    against the per-step loop, bit for bit."""
    from ctrlhair_tpu_torch.data.landmark_dataset import training_batch
    cfg = LandmarkNetConfig(input_size=32, base_channels=4, stages=2,
                            hidden_dim=16)

    def make_batch(seed):
        return {k: torch.tensor(v) for k, v in training_batch(
            np.random.default_rng(seed), 4, cfg.input_size).items()}

    tr = LandmarkTrainer(cfg, device='cpu')
    ref = tr.init_state(0)
    for s in range(5):
        ref, _ = tr.train_step(ref, make_batch(s))
    state = tr.init_state(0)
    state, rows, trips = ChunkRunner(tr.train_step, make_batch).run(
        state, 0, 5, chunk_size=2, record_every=2)
    assert trips == 0 and [r['step'] for r in rows] == [0, 2, 4]
    assert_trees(state.to_tree(), ref.to_tree(), 0)


def test_chunked_refuses_what_it_cannot_run():
    """A state at another step than the run's start, and a non-scalar
    metric.  A trainer over a mesh is not refused on the CPU, where its
    chunk runs eagerly (tests/test_torch_chunked_trainers.py runs one on
    two gloo ranks); the card refuses a gloo mesh, whose collectives run
    on the host (tests/test_torch_cuda.py)."""
    tr = pst.ShapeTrainer(PORT_SHAPE, device='cpu', mesh=object())

    @functools.wraps(tr.train_step)
    def wrapped(*args):
        return tr.train_step(*args)

    for step_fn in (tr.train_step, functools.partial(tr.train_step),
                    wrapped):
        assert chunked._mesh_of(step_fn) is tr.mesh
        ChunkRunner(step_fn, lambda s: None)
    tr, state, make_batch, make_draws = port_shape()
    runner = runner_of(tr, make_batch, make_draws)
    with pytest.raises(ValueError, match='at step 0'):
        runner.run(state, 3, 5)

    def vector_metrics(state, batch, draws):
        state, m = tr.train_step(state, batch, draws)
        return state, {**m, 'vector': torch.zeros(2)}

    with pytest.raises(ValueError, match='scalar'):
        ChunkRunner(vector_metrics, make_batch, make_draws=make_draws,
                    batch_seed=BATCH_SEED, step_seed=STEP_SEED).run(
            state, 0, 1)


def tiny_trainers():
    """{name: () -> (state, step)} of the six trainers that ChunkRunner
    runs, at the tests' tiny configs on the CPU: `step(state)` takes one
    step on a seeded batch with the trainer's own draws."""
    from ctrlhair_tpu_torch.data.landmark_dataset import training_batch
    from ctrlhair_tpu_torch.training.bisenet_trainer import BiSeNetTrainer
    from ctrlhair_tpu_torch.training.color_texture_trainer import (
        ColorTextureTrainer, synthetic_batch as ct_synthetic)
    from ctrlhair_tpu_torch.training.predictor_trainer import (
        PredictorTrainer)
    from test_torch_bisenet_trainer import CFG as BISENET, bisenet_batch
    from test_torch_sean_trainer import (
        BATCH as SEAN_BATCH, port_trainer as sean_trainer, sean_batch)
    from test_torch_trainers import (
        TINY_CT, predictor_batch, predictor_cfgs)

    def shape():
        tr, state, make_batch, make_draws = port_shape()
        return state, lambda st: tr.train_step(st, make_batch(0),
                                               make_draws(0))

    def landmark():
        cfg = LandmarkNetConfig(input_size=32, base_channels=4, stages=2,
                                hidden_dim=16)
        tr = LandmarkTrainer(cfg, device='cpu')
        batch = {k: torch.tensor(v) for k, v in training_batch(
            np.random.default_rng(0), 4, cfg.input_size).items()}
        return tr.init_state(0), lambda st: tr.train_step(st, batch)

    def color_texture():
        cfg = port_cfg(TINY_CT)
        tr = ColorTextureTrainer(cfg, device='cpu')
        state, preds = tr.init_state()
        batch = ct_synthetic(torch.Generator().manual_seed(0), cfg, 8)
        return state, lambda st: tr.train_step(st, batch, preds,
                                               tr.draws(0, 8))

    def predictor(which):
        def build():
            tr = PredictorTrainer(port_cfg(predictor_cfgs()[which]),
                                  device='cpu')
            batch = to_torch(predictor_batch(which, 0))
            return tr.init_state(), lambda st: tr.train_step(
                st, batch, tr.draws(0, batch['code'].shape[0]))
        return build

    def face_parser():
        tr = BiSeNetTrainer(BISENET, device='cpu')
        batch = to_torch(bisenet_batch(0))
        return tr.init_state(), lambda st: tr.train_step(st, batch)

    def sean():
        tr = sean_trainer()
        batch = to_torch(sean_batch(0))
        return tr.init_state(), lambda st: tr.train_step(
            st, batch, tr.draws(0, SEAN_BATCH))

    return {'shape': shape, 'landmark': landmark,
            'color_texture': color_texture, 'rgb': predictor('rgb'),
            'curliness': predictor('curliness'), 'face_parser': face_parser,
            'sean': sean}


@pytest.mark.parametrize('name', ['shape', 'landmark', 'color_texture',
                                  'rgb', 'curliness', 'face_parser', 'sean'])
def test_state_updates_in_place(name):
    """A step and load_tree write the state's own tensors (Adam's count
    and the SEAN trainer's power-iteration vectors included), as a graph
    captured over the step needs: every tensor of state.tensors() keeps its
    identity and its pointer, and the step moved the state."""
    state, step = tiny_trainers()[name]()
    tensors = state.tensors()
    ptrs = [t.data_ptr() for t in tensors]
    before = [t.clone() for t in tensors]
    tree = state.to_tree()
    state, _ = step(state)
    assert state.step == 1
    assert [t.data_ptr() for t in state.tensors()] == ptrs
    assert all(a is b for a, b in zip(state.tensors(), tensors))
    assert any(not torch.equal(a, b) for a, b in zip(tensors, before))
    state.load_tree(tree)
    assert state.step == 0
    assert [t.data_ptr() for t in state.tensors()] == ptrs
    assert all(a is b for a, b in zip(state.tensors(), tensors))
    assert all(torch.equal(a, b) for a, b in zip(tensors, before))


@pytest.mark.parametrize('name', ['shape', 'landmark', 'color_texture',
                                  'rgb', 'curliness', 'face_parser', 'sean'])
def test_fresh_leaves_drop_held_accumulators(name):
    """_fresh_leaves, which ChunkRunner applies to the state's tensors
    before it captures: a copy of the state taken with gradients on (the
    caller's clone()) holds each parameter's gradient accumulator, on the
    card one made on the default stream, which a captured backward must
    not reach.  After it every tensor keeps its object, pointer and
    values, each trainable leaf reaches an accumulator of its own and not
    the copy's, and the next step equals a step without it bit for bit."""
    from torch.autograd.graph import get_gradient_edge
    state, step = tiny_trainers()[name]()
    ref, ref_step = tiny_trainers()[name]()
    state, _ = step(state)
    ref, _ = ref_step(ref)
    tensors = state.tensors()
    ptrs = [t.data_ptr() for t in tensors]
    copy = [t.clone() for t in tensors]
    held = [(t, c.grad_fn.next_functions[0][0])
            for t, c in zip(tensors, copy) if c.grad_fn is not None]
    assert held and all(get_gradient_edge(t).node is node
                        for t, node in held)
    chunked._fresh_leaves(tensors)
    assert all(a is b for a, b in zip(state.tensors(), tensors))
    assert [t.data_ptr() for t in state.tensors()] == ptrs
    assert all(torch.equal(t, c) for t, c in zip(tensors, copy))
    for t, node in held:
        assert t.is_leaf and t.requires_grad
        assert get_gradient_edge(t).node is not node
        assert node.variable is not t
    state, _ = step(state)
    ref, _ = ref_step(ref)
    assert all(torch.equal(a, b) for a, b in zip(state.tensors(),
                                                 ref.tensors()))


def test_loss_schedule_device_tables():
    """The loss schedule's device tables give the host's weights, and a
    step moves Adam's count in place."""
    tr, state, make_batch, make_draws = port_shape()
    state, _ = tr.train_step(state, make_batch(0), make_draws(0))
    assert int(state.gen.count) == 1
    cfg = dataclasses.replace(PORT_SHAPE, lambda_kl={0: 0.1, 3: 0.5, 7: 1.0})
    sch = L.LossSchedule(cfg)
    for step in range(10):
        for dtype in (torch.int32, torch.int64):
            for name in ('lambda_kl', 'lambda_hair'):
                got = sch.weight(name, torch.tensor(step, dtype=dtype))
                assert got.dtype == torch.float32
                assert float(got) == np.float32(sch.weight_host(name, step))
    assert len(sch._device_tables) == 4


def test_captured_step_cannot_draw_for_itself():
    """A step whose index is a tensor, as under capture, raises where it
    would seed its own draws from it."""
    from ctrlhair_tpu_torch.training.predictor_trainer import step_generator
    with pytest.raises(TypeError, match='make_draws'):
        step_generator(0, torch.tensor(3))
    tr, state, make_batch, _ = port_shape()
    state.step = torch.tensor(0)
    with pytest.raises(TypeError, match='make_draws'):
        tr.train_step(state, make_batch(0))
