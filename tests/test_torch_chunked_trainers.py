# The port's ChunkRunner (ctrlhair_tpu_torch/training/chunked.py) over the
# colour/texture (lambda_rec_img off and on), predictor, face-parser and
# SEAN trainers, against JAX's ChunkRunner (ctrlhair_tpu/training/
# chunked.py) over JAX's same trainers, and against the port's own
# per-step loop; tests/test_torch_chunked.py holds the shape and landmark
# trainers.  On the CPU the port's runner takes its steps eagerly.
#
# Against JAX: both sides start from one state (JAX's initial state, or for
# colour/texture the port's, through the flax state-dict layout both
# share) and run 3 steps in chunks of 2.  Both take the batch of step s
# from seed BATCH_SEED + s and the draws from seed STEP_SEED + s: JAX's
# runner hands its step PRNGKey(STEP_SEED + s), from which the JAX step
# draws, and the port is handed the draws JAX makes from that key (the
# helpers of the trainers' own parity tests); the batches are numpy
# functions of the seed, which JAX's make_batch gathers from a pool on its
# device by the key's seed (as JAX's soak gathers from device pools).  The
# frozen predictors ride as extra arguments on both sides, as JAX's soak
# passes them, and so do JAX's VGG19 weights.  Bars, as the trainers' own
# three-step tests hold them: on_chunk sees [2, 3] on both sides, no trips,
# rows at the same steps, every recorded loss and every leaf of the state
# within THREE_STEPS (1e-4 of the leaf's scale); the face parser computes
# in float64 on both sides, as tests/test_torch_bisenet_trainer.py holds
# it; SEAN at that file's tiny config, spectral norm and ACE noise on, so
# that u and the noise cross a chunk boundary.  The rounding-noise
# exemptions are those of the trainers' own tests: the predictors' shadowed
# biases (tests/test_torch_trainers.py), whose values before each step
# ride as scalar metrics on both sides for the running-mean offset; SEAN's
# noise entries (tests/test_torch_sean_trainer.py), read after each chunk
# and, for the first step inside the first chunk, from each runner's run
# of that step alone; a chunk of k steps may move an exempt entry 2 lr a
# step.
#
# Against itself, bit for bit: 5 steps in chunks of 2, a NaN batch at step
# 3 in the second chunk (one trip), each trainer with its own draws.
#
# Over a mesh: the colour/texture trainer at TINY_CT on 2 gloo ranks (the
# ranks' code in tests/torch_parallel_ranks.py), chunked for 3 steps in
# chunks of 2, against JAX's ChunkRunner over make_mesh(2, tp=1) (state
# and predictors replicated, the batch sharded) within 1e-5 (the parallel
# bar, with the exemption of tests/test_torch_parallel_trainers.py, read as
# for SEAN), and bit-equal to the port's per-step loop on the same ranks.
#
# About 3 minutes alone, most of it JAX's compiles: each JAX runner
# compiles its chunk of 2 and its remainder of 1 (SEAN's about 80 s).
import concurrent.futures
import dataclasses
import functools

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from ctrlhair_tpu.models.sean import SEAN as JaxSEAN
from ctrlhair_tpu.parallel import mesh as jmesh
from ctrlhair_tpu.training.bisenet_trainer import (
    BiSeNetTrainer as JaxBiSeNetTrainer)
from ctrlhair_tpu.training.chunked import ChunkRunner as JaxChunkRunner
from ctrlhair_tpu.training.color_texture_trainer import (
    ColorTextureTrainer as JaxCTTrainer, synthetic_batch as jax_ct_batch)
from ctrlhair_tpu.training.predictor_trainer import (
    PredictorTrainer as JaxPredictorTrainer)
from ctrlhair_tpu_torch.convert import to_flax
from ctrlhair_tpu_torch.models.sean import SEAN
from ctrlhair_tpu_torch.parallel.dryrun import run_on_ranks
from ctrlhair_tpu_torch.training import bisenet_trainer as pbt
from ctrlhair_tpu_torch.training.chunked import ChunkRunner
from ctrlhair_tpu_torch.training.color_texture_trainer import (
    ColorTextureTrainer)
from ctrlhair_tpu_torch.training.predictor_trainer import PredictorTrainer
from ctrlhair_tpu_torch.training.sean_trainer import load_vgg
from test_torch_bisenet_trainer import (
    CFG as BISENET, JCFG as JAX_BISENET, bisenet_batch, float64_state, x64)
from test_torch_sean_trainer import (
    BATCH as SEAN_BATCH, LRS as SEAN_LRS, TINY as TINY_SEAN_TRAINER,
    jax_noise, jax_trainer as jax_sean_trainer, noise_entries,
    port_trainer as port_sean_trainer, sean_batch, with_noise_var)
from test_torch_trainers import (
    THREE_STEPS, TINY_CT, TINY_SEAN, assert_trees,
    assert_trees_noise_exempt, check_predictor_states, ct_batch, jax_draws,
    jax_dropout_masks, port_cfg, predictor_batch, predictor_cfgs,
    shadowed_layers, state_dict, to_torch)
import torch_parallel_ranks as ranks

BATCH_SEED, STEP_SEED = 2_000_000, 300
STEPS, CHUNK = 3, 2
CT_N = 8
PARALLEL, NOISE_SHARE_MAX = 1e-5, 1e-3
CT_REC = dataclasses.replace(TINY_CT, lambda_rec_img={0: 10.0})


def pooled(make):
    """(JAX's make_batch(key), the port's make_batch(seed)) of the numpy
    batches make(seed) of the seeds BATCH_SEED .. BATCH_SEED + STEPS - 1:
    JAX's gathers the batch of the key's seed from a pool on its device."""
    batches = [make(BATCH_SEED + i) for i in range(STEPS)]
    pool = {k: jnp.stack([b[k] for b in batches]) for k in batches[0]}

    def jax_batch(key):
        i = key[-1].astype(jnp.int32) - BATCH_SEED
        return {k: v[i] for k, v in pool.items()}

    return jax_batch, lambda seed: to_torch(batches[seed - BATCH_SEED])


def run_jax(step_fn, state, make_batch, extra=(), first=False):
    """JAX's runner, 3 steps in chunks of 2: (state dict, rows, trips,
    [(step, state dict)] after each chunk, and with `first` the state
    after the same runner's 1-step run over [0, 1) (the executable of the
    remainder chunk, so no compile more), else None)."""
    seen = []
    runner = JaxChunkRunner(step_fn, make_batch, batch_seed=BATCH_SEED,
                            step_seed=STEP_SEED)
    start = jax.tree_util.tree_map(jnp.copy, state) if first else None
    state, rows, trips = runner.run(
        state, 0, STEPS, chunk_size=CHUNK, record_every=1, extra_args=extra,
        on_chunk=lambda s, st, rws: seen.append((s, state_dict(st))))
    if first:
        start, _, _ = runner.run(start, 0, 1, chunk_size=CHUNK,
                                 extra_args=extra)
        start = state_dict(start)
    return state_dict(state), rows, trips, seen, start


def run_port(step_fn, state, make_batch, make_draws, extra=(), first=None):
    """The port's runner, as run_jax; `first`, a second state at the same
    start, for the 1-step run."""
    one = None
    seen = []
    runner = ChunkRunner(step_fn, make_batch, make_draws=make_draws,
                         batch_seed=BATCH_SEED, step_seed=STEP_SEED)
    state, rows, trips = runner.run(
        state, 0, STEPS, chunk_size=CHUNK, record_every=1, extra_args=extra,
        on_chunk=lambda s, st, rws: seen.append((s, st.to_tree())))
    if first is not None:
        one, _, _ = runner.run(first, 0, 1, chunk_size=CHUNK,
                               extra_args=extra)
        one = one.to_tree()
    return state.to_tree(), rows, trips, seen, one


def check_runs(port, jax_run, skip=()):
    """The bars every case shares: the chunks, the trips, the rows and
    every recorded loss (metrics whose key starts with one of `skip`
    aside)."""
    _, prows, ptrips, pseen, _ = port
    _, jrows, jtrips, jseen, _ = jax_run
    assert [s for s, _ in pseen] == [s for s, _ in jseen] == [2, 3]
    assert ptrips == jtrips == 0
    assert [r['step'] for r in prows] == [r['step'] for r in jrows] \
        == list(range(STEPS))
    for pr, jr in zip(prows, jrows):
        assert set(pr) == set(jr)
        for k, v in jr.items():
            if not k.startswith(skip):
                assert abs(pr[k] - v) <= THREE_STEPS * max(1.0, abs(v)), k


def noise_in_parts(parts):
    """noise(got, ref, exempt) that adds to `exempt` the entries of the
    given Adam-trained parts whose first moment is below 1e-5 of the
    largest of its part on JAX's side and not reproduced by the port to
    1% (the SEAN test's noise_entries, for any parts: a bias that a
    normalisation cancels is noise in every entry, so its own leaf gives
    no scale)."""
    def noise(got, ref, exempt):
        for part in parts:
            mus = [{jax.tree_util.keystr(p): np.asarray(v) for p, v in
                    jax.tree_util.tree_flatten_with_path(
                        t[part]['opt_state']['0']['mu'])[0]}
                   for t in (got, ref)]
            scale = max(np.abs(v).max() for v in mus[1].values())
            for k, m in mus[1].items():
                mask = (np.abs(m) <= 1e-5 * scale) & (
                    np.abs(mus[0][k] - m) > 1e-2 * np.abs(m))
                if mask.any():
                    exempt[(part, k)] = exempt.get((part, k), False) | mask
    return noise


def assert_chunks_noise_exempt(port_seen, jax_seen, init, lrs, b1, tol,
                               noise, first=None):
    """assert_trees_noise_exempt after each chunk, the exemptions
    accumulated over the chunks, a chunk of k steps allowed to move an
    exempt entry 2 lr a step; `noise(got, ref, exempt)` adds the entries
    whose gradient is rounding noise against its model's largest (as
    tests/test_torch_sean_trainer.py's noise_entries does), also read from
    `first`, the two sides' states after a run of the first step alone (a
    snapshot inside the first chunk, which a runner does not give).
    Returns the count of exempt entries."""
    exempt, prev, count = {}, (init, init), 0
    if first is not None:
        noise(*first, exempt)
    for (s, got), (_, ref) in zip(port_seen, jax_seen):
        steps = s - int(prev[1]['step'])
        noise(got, ref, exempt)
        count = assert_trees_noise_exempt(
            got, ref, *prev, {k: steps * v for k, v in lrs.items()}, b1,
            tol, exempt)
        prev = (got, ref)
    return count


# ----------------------------------------------------------- colour/texture
def port_ct(rec_img):
    """The port's colour/texture trainer at the tiny config, with a seeded
    tiny frozen SEAN for lambda_rec_img: (cfg, trainer, state,
    predictors)."""
    from ctrlhair_tpu_torch.models.layers import init_parameters_
    cfg = CT_REC if rec_img else TINY_CT
    sean = None
    if rec_img:
        sean = SEAN(port_cfg(TINY_SEAN))
        init_parameters_(sean, torch.Generator().manual_seed(1))
    ptr = ColorTextureTrainer(port_cfg(cfg), sean=sean, device='cpu')
    pstate, ppred = ptr.init_state(2)
    return cfg, ptr, pstate, ppred


def ct_trainers(rec_img):
    """The port's trainer and JAX's on the same SEAN, state and
    predictors (JAX's rebuilt from the port's through the flax layout):
    (cfg, JAX trainer, JAX state, JAX predictors, trainer, state,
    predictors)."""
    cfg, ptr, pstate, ppred = port_ct(rec_img)
    sean = ptr.sean
    jtr = JaxCTTrainer(cfg, sean=None if sean is None else JaxSEAN(TINY_SEAN),
                       sean_params=None if sean is None
                       else to_flax(sean, 'sean'))
    jstate = flax.serialization.from_state_dict(
        jax.eval_shape(lambda: jtr.init_state(jax.random.PRNGKey(0))[0]),
        pstate.to_tree())
    jpred = {k: to_flax(p, k) for k, p in ppred.items()}
    return cfg, jtr, jstate, jpred, ptr, pstate, ppred


def ct_chunk_step(trainer):
    """The port's colour/texture step in the runner's argument order
    (state, batch, draws, predictors), as JAX's soak wraps its own."""
    @functools.wraps(trainer.train_step)
    def step(state, batch, draws, predictors):
        return trainer.train_step(state, batch, predictors, draws)
    return step


@pytest.mark.parametrize('rec_img', [False, True])
def test_color_texture_chunked_against_jax(rec_img):
    cfg, jtr, jstate, jpred, ptr, pstate, ppred = ct_trainers(rec_img)
    jax_batch, port_batch = pooled(
        lambda seed: ct_batch(cfg, seed, CT_N, rec_img))
    jax_run = run_jax(lambda st, b, rng, preds: jtr._train_step(
        st, b, preds, rng), jstate, jax_batch, (jpred,))
    port = run_port(ct_chunk_step(ptr), pstate, port_batch,
                    lambda seed: jax_draws(jax.random.PRNGKey(seed), CT_N,
                                           cfg.gan_input_from_encoder_prob),
                    (ppred,))
    check_runs(port, jax_run)
    assert ('g/lambda_rec_img' in port[1][0]) == rec_img
    assert_trees(port[0], jax_run[0], THREE_STEPS)


# --------------------------------------------------------------- predictors
def bias_metrics(get):
    """A step wrapper that adds each shadowed bias entry as it was before
    the step (`get(state)` -> {layer: bias}) to the step's metrics."""
    def wrap(step):
        def run(state, *args):
            biases = get(state)
            state, metrics = step(state, *args)
            return state, {**metrics, **{
                f'bias/{layer}/{j}': b[j] for layer, b in biases.items()
                for j in range(b.shape[0])}}
        return run
    return wrap


def bias_tree(biases):
    """A tree holding only the shadowed biases, where
    check_predictor_states reads them."""
    return {'model': {'params': {'params': {'net': {
        layer: {'fc': {'bias': np.asarray(b)}}
        for layer, b in biases.items()}}}}}


def bias_rows(rows, layers):
    """{layer: bias} before each step, from the rows' bias metrics."""
    return [{layer: np.array([r[k] for k in sorted(
        (k for k in r if k.startswith(f'bias/{layer}/')),
        key=lambda k: int(k.rsplit('/', 1)[1]))], np.float32)
        for layer in layers} for r in rows]


@pytest.mark.parametrize('which', ['rgb', 'curliness'])
def test_predictor_chunked_against_jax(which):
    cfg = predictor_cfgs()[which]
    layers = shadowed_layers(cfg)
    jtr = JaxPredictorTrainer(cfg)
    jstate = jtr.init_state(jax.random.PRNGKey(0))
    init = state_dict(jstate)
    ptr = PredictorTrainer(port_cfg(cfg), device='cpu')
    pstate = ptr.init_state()
    pstate.load_tree(init)
    variables = dict(jstate.model.params, batch_stats=jstate.stats)

    def make_draws(seed):
        # the keep masks flax draws from this key; any batch whose dropout
        # inputs are nonzero shows them (leaky ReLU before the dropout)
        code = predictor_batch(which, seed)['code']
        return {'dropout': jax_dropout_masks(
            cfg, variables, code, jax.random.PRNGKey(seed))}

    jax_batch, port_batch = pooled(lambda seed: predictor_batch(which, seed))
    jax_get = lambda st: {layer: st.model.params['params']['net'][layer][
        'fc']['bias'] for layer in layers}
    port_get = lambda st: {layer: getattr(
        st.model.module.net, layer).fc.bias.detach().clone()
        for layer in layers}
    jax_run = run_jax(bias_metrics(jax_get)(jtr._train_step), jstate,
                      jax_batch)
    port = run_port(bias_metrics(port_get)(ptr.train_step), pstate,
                    port_batch, make_draws)
    check_runs(port, jax_run, skip=('bias/',))
    before = zip(bias_rows(port[1], layers), bias_rows(jax_run[1], layers))
    history = [(bias_tree(p), bias_tree(j)) for p, j in before]
    assert_trees(history[0][0], history[0][1], 0)
    history.append((port[0], jax_run[0]))
    check_predictor_states(cfg, port[0], jax_run[0], THREE_STEPS, history)


# --------------------------------------------------------------- face parser
def test_face_parser_chunked_against_jax():
    """The face parser, both sides computing in float64 (its parameters,
    trace and statistics float32), as tests/test_torch_bisenet_trainer.py
    holds it."""
    from ctrlhair_tpu.models.bisenet import BiSeNet as JaxBiSeNet
    with x64():
        jtr = JaxBiSeNetTrainer(JAX_BISENET)
        jtr.model = JaxBiSeNet(JAX_BISENET, train=True, return_aux=True,
                               dtype=jnp.float64)
        jstate = jtr.init_state(jax.random.PRNGKey(0))
        # the statistics in float64, which JAX's float64 model makes of
        # them at its first step (the scan's carry keeps its types)
        jstate = jstate.replace(stats=jax.tree_util.tree_map(
            lambda v: v.astype(jnp.float64), jstate.stats))
        init = state_dict(jstate)
        jax_batch, port_batch = pooled(bisenet_batch)
        jax_run = run_jax(jtr._train_step, jstate, jax_batch)
    ptr = pbt.BiSeNetTrainer(BISENET, device='cpu')
    pstate = float64_state(ptr)
    pstate.load_tree(init)
    port = run_port(ptr.train_step, pstate, port_batch, None)
    check_runs(port, jax_run)
    assert_trees(port[0], jax_run[0], THREE_STEPS)


# --------------------------------------------------------------------- SEAN
def test_sean_chunked_against_jax():
    """SEAN with spectral norm and ACE noise: after each chunk the state
    (u vectors included) within the bar, the entries whose gradient is
    rounding noise exempt as tests/test_torch_sean_trainer.py exempts
    them (at most 1% of the trained entries); the first chunk's two steps
    may move such an entry 2 lr each."""
    jtr = jax_sean_trainer()
    key = jax.random.PRNGKey(0)
    jtr.vgg_params = jax.jit(jtr.vgg.init)(
        key, jnp.zeros((1, TINY_SEAN_TRAINER.crop_size,
                        TINY_SEAN_TRAINER.crop_size, 3)))
    jstate = with_noise_var(jax.jit(jtr.init_state)(key))
    init = state_dict(jstate)
    ptr = port_sean_trainer()
    pstate, again = ptr.init_state(), ptr.init_state()
    load_vgg(ptr.vgg, jax.device_get(jtr.vgg_params))     # after the inits
    pstate.load_tree(init)
    again.load_tree(init)
    jax_batch, port_batch = pooled(sean_batch)
    jax_run = run_jax(jtr._train_step, jstate, jax_batch,
                      (jtr.vgg_params,), first=True)
    port = run_port(ptr.train_step, pstate, port_batch,
                    lambda seed: jax_noise(jax.random.PRNGKey(seed),
                                           TINY_SEAN_TRAINER, SEAN_BATCH),
                    first=again)
    check_runs(port, jax_run)
    total = sum(np.size(v) for part in SEAN_LRS for v in
                jax.tree_util.tree_leaves(init[part]['params']))
    n = assert_chunks_noise_exempt(port[3], jax_run[3], init, SEAN_LRS,
                                   0.0, THREE_STEPS, noise_entries,
                                   (port[4], jax_run[4]))
    assert n <= 0.01 * total, (n, total)
    for key in ('sn_u', 'dis_sn_u'):
        assert any(not np.array_equal(a, b) for a, b in zip(
            jax.tree_util.tree_leaves(init[key]),
            jax.tree_util.tree_leaves(port[0][key])))


# ---------------------------------------------- the port against itself
NAN_STEP, SELF_STEPS = 3, 5


def self_case(name):
    """(trainer's chunk step, state builder, make_batch(seed, nan),
    make_draws or None, extra args) of one trainer of the port."""
    if name in ('color_texture', 'color_texture_rec_img'):
        rec_img = name == 'color_texture_rec_img'
        cfg, ptr, _, ppred = port_ct(rec_img)
        return (ct_chunk_step(ptr), lambda: ptr.init_state(1)[0],
                lambda seed, nan: to_torch(ct_batch(cfg, seed, CT_N, rec_img,
                                                    nan=nan)),
                lambda seed: ptr.draws(seed, CT_N), (ppred,))
    if name in ('rgb', 'curliness'):
        ptr = PredictorTrainer(port_cfg(predictor_cfgs()[name]),
                               device='cpu', seed=2)
        return (ptr.train_step, lambda: ptr.init_state(1),
                lambda seed, nan: to_torch(predictor_batch(name, seed,
                                                           nan=nan)),
                lambda seed: ptr.draws(seed, 32), ())
    if name == 'face_parser':
        ptr = pbt.BiSeNetTrainer(BISENET, device='cpu')
        return (ptr.train_step, lambda: ptr.init_state(1),
                lambda seed, nan: to_torch(bisenet_batch(seed, nan=nan)),
                None, ())
    ptr = port_sean_trainer()
    return (ptr.train_step, lambda: ptr.init_state(1),
            lambda seed, nan: to_torch(sean_batch(seed, nan=nan)),
            lambda seed: ptr.draws(seed, SEAN_BATCH), ())


@pytest.mark.parametrize('name', ['color_texture', 'color_texture_rec_img',
                                  'rgb', 'curliness', 'face_parser', 'sean'])
def test_chunked_equals_per_step_with_a_nan(name):
    """5 steps in chunks of 2 against the per-step loop, bit for bit; the
    NaN batch at step 3, inside the second chunk, is one trip."""
    step, build, batch, draws, extra = self_case(name)

    def make_batch(seed):
        return batch(seed, seed == BATCH_SEED + NAN_STEP)

    ref = build()
    flags = []
    for s in range(SELF_STEPS):
        args = () if draws is None else (draws(STEP_SEED + s),)
        ref, m = step(ref, make_batch(BATCH_SEED + s), *args, *extra)
        flags.append(float(m['finite']))
    state, rows, trips = ChunkRunner(
        step, make_batch, make_draws=draws, batch_seed=BATCH_SEED,
        step_seed=STEP_SEED).run(build(), 0, SELF_STEPS, chunk_size=CHUNK,
                                 record_every=1, extra_args=extra)
    assert flags == [1.0, 1.0, 1.0, 0.0, 1.0]
    assert trips == 1 and [r['finite'] for r in rows] == flags
    assert state.step == SELF_STEPS
    assert_trees(state.to_tree(), ref.to_tree(), 0)


# ------------------------------------------------------------ over a mesh
WORLD = 2


def test_color_texture_chunked_over_two_ranks():
    """The colour/texture trainer at TINY_CT on 2 gloo ranks, chunked, 3
    steps in chunks of 2: within 1e-5 of JAX's runner over make_mesh(2,
    tp=1), every rank alike, and bit-equal to the port's per-step loop on
    the same ranks."""
    cfg = TINY_CT
    jtr = JaxCTTrainer(cfg)
    jstate, jpred = jtr.init_state(jax.random.PRNGKey(0))
    batches = {BATCH_SEED + i: {k: np.asarray(v) for k, v in jax_ct_batch(
        jax.random.PRNGKey(BATCH_SEED + i), cfg, CT_N).items()}
        for i in range(STEPS)}
    draws = {STEP_SEED + i: {k: np.asarray(v.numpy()) for k, v in jax_draws(
        jax.random.PRNGKey(STEP_SEED + i), CT_N,
        cfg.gan_input_from_encoder_prob).items()} for i in range(STEPS)}
    spec = {'cfg': port_cfg(cfg), 'init_tree': state_dict(jstate),
            'pred_trees': {k: jax.device_get(v) for k, v in jpred.items()},
            'batches': batches, 'draws': draws, 'batch_seed': BATCH_SEED,
            'step_seed': STEP_SEED, 'steps': STEPS, 'chunk': CHUNK}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        on_ranks = pool.submit(run_on_ranks, ranks.ct_chunked_on_rank,
                               WORLD, spec, deadline_s=240.0)
        mesh = jmesh.make_mesh(WORLD, tp=1)
        sharding = NamedSharding(mesh, P('dp'))
        with mesh:
            state = jax.device_put(jstate, jmesh.replicated(mesh))
            preds = jax.device_put(jpred, jmesh.replicated(mesh))

            def make_batch(key):
                return jax.lax.with_sharding_constraint(
                    jax_ct_batch(key, cfg, CT_N), sharding)

            _, jrows, jtrips, jseen, jfirst = run_jax(
                lambda st, b, rng, p: jtr._train_step(st, b, p, rng),
                state, make_batch, (preds,), first=True)
        per_rank = on_ranks.result()
    assert jtrips == 0
    lrs = {'gen': cfg.lr_g, 'dis': cfg.lr_d, 'dis_noise': cfg.lr_g}
    total = sum(np.size(v) for part in lrs for v in
                jax.tree_util.tree_leaves(spec['init_tree'][part]['params']))
    for chunked, per_step, rows, trips, seen, first in per_rank:
        assert trips == 0
        assert [r['step'] for r in rows] == [r['step'] for r in jrows]
        for pr, jr in zip(rows, jrows):
            assert set(pr) == set(jr)
            for k, v in jr.items():
                assert abs(pr[k] - v) <= PARALLEL * max(1.0, abs(v)), k
        assert [s for s, _ in seen] == [s for s, _ in jseen] == [2, 3]
        n = assert_chunks_noise_exempt(seen, jseen, spec['init_tree'], lrs,
                                       cfg.beta1, PARALLEL,
                                       noise_in_parts(lrs), (first, jfirst))
        assert n <= NOISE_SHARE_MAX * total, (n, total)
        assert_trees(seen[-1][1], chunked, 0)
        assert_trees(chunked, per_step, 0)
        assert_trees(chunked, per_rank[0][0], 0)
