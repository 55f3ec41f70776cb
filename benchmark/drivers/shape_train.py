"""The shape VAE-GAN's training step (CtrlHair's 054) through
training/chunked.ChunkRunner (its CUDA graph on the card), on fresh seeded
masks, each step's draws made on the host.

Set-up builds one ShapeTrainer state with the weights of its generator,
discriminator and latent-prior discriminator drawn from the seed
(benchmark/weights.py), fills a pool of `pool_batches` batches on the
device (four one-hot masks a batch, `target`, `face`, `hair` and `real`,
[batch, S, S, 19], each pixel's class uniform over the 19: the contract
of shape_trainer.synthetic_batch), and takes the first `first_steps`
steps through the runner, the graph captured on the first.  Step s takes
batch s mod the pool and the trainer's host draws of step s
(`make_draws`).  Set-up ends with `settle_seconds` of chunks: on an H100
the step ran about 2.5% slower for a stretch of random length, up to
about 26 s, after the set-up's allocations and capture, and windows that
began at once read 32.8 or 33.5 samples/s by that alone.  The window then
runs chunks of the configuration's chunk size until `--seconds` have
passed, the clock stopped by the runner's read of the last chunk's
metrics; a traced run times `trace_chunks` chunks.

The check: the float32 reference (benchmark/reference/shape_train.py)
takes the same first steps from the same weights, batches and draws.
Compared, each against its limit, as the SEAN cell compares them
(benchmark/drivers/sean_train.py):
  loss_gap    the largest relative gap of G's, D's and Dz's losses in the
              first step (the later steps' as `loss_gap_steps`, printed);
  grad_gap    the first step's gradient (Adam's first moment after one
              step, over 1 - beta1), by the worst leaf of the families
              gen., dis. and dis_noise.: the gap between the two norms over
              the larger of the reference leaf's norm and its family's
              median leaf's;
  change_gap  the same for each parameter's change over the first steps.
A leaf whose reference gradient is under a thousandth of its family's
median leaf is left out of the last two.  Under `control` the readings of
the TF32 control and of the planted faults (`fault_half_batch`: each
batch's and draw's first half; `fault_r0_first_order`: D's R0 input
gradient taken without create_graph) are printed beside the program's.
"""

from __future__ import annotations

import gc
import time
from typing import Dict

import numpy as np
import torch

from benchmark import harness, weights
from benchmark.drivers.sean_train import leaf_norms, set_tf32
from benchmark.flops import shape_train as flops
from benchmark.reference import shape_train as ref
from benchmark.reference.nn import sub
from benchmark.trace import Tracer

from ctrlhair_tpu_torch.config import ShapeConfig
from ctrlhair_tpu_torch.training.chunked import ChunkRunner
from ctrlhair_tpu_torch.training.shape_trainer import ShapeTrainer

PARTS = (('gen.', 'gen'), ('dis.', 'dis'), ('dis_noise.', 'dis_noise'))
MASKS = ('target', 'face', 'hair', 'real')
LOSSES = ('g_total', 'd_total', 'dz_total')
EXCLUDE_BELOW = 1e-3


def compare(prog, refr, skip) -> Dict[str, float]:
    """A run's readings against the reference's: `loss_gap` of the first
    step, `loss_gap_steps` the largest over all the first steps,
    `grad_gap` and `change_gap`."""
    rel = [max(abs(a - b) / abs(b) for a, b in zip(pa, pb))
           for pa, pb in zip(prog['losses'], refr['losses'])]
    out = {'loss_gap': rel[0], 'loss_gap_steps': max(rel)}
    for key in ('grads', 'changes'):
        worst = 0.0
        for fam, _ in PARTS:
            names = [k for k in refr[key] if k.startswith(fam)
                     and k not in skip]
            med = float(np.median([refr[key][k] for k in names]))
            for k in names:
                worst = max(worst, abs(prog[key][k] - refr[key][k])
                            / max(refr[key][k], med))
        out[key[:-1] + '_gap'] = worst
    return out


def excluded(grads: Dict[str, float]):
    out = set()
    for fam, _ in PARTS:
        names = [k for k in grads if k.startswith(fam)]
        med = float(np.median([grads[k] for k in names]))
        out |= {k for k in names if grads[k] < EXCLUDE_BELOW * med}
    return out


def reference_readings(cfg, p0, batches, draws, tf32: bool = False,
                       half: bool = False, r0_first_order: bool = False):
    """The reference's losses, first gradient and change over the first
    steps, computed in float32 (TF32 under `tf32`); `half` and
    `r0_first_order` plant the calibration's faults."""
    set_tf32(tf32)
    sh, b1 = cfg['shape'], cfg['shape']['beta1']
    st = ref.State(p0)
    losses, grads = [], None
    for i, (b, d) in enumerate(zip(batches, draws)):
        if half:
            b = {k: v[:v.shape[0] // 2] for k, v in b.items()}
            d = {k: v[:v.shape[0] // 2] if v.dim() else v
                 for k, v in d.items()}
        r = ref.step(st, sh, b, d, r0_first_order=r0_first_order)
        losses.append(tuple(r[k] for k in LOSSES))
        if i == 0:
            grads = leaf_norms({k: v / (1 - b1) for k, v in st.mu.items()})
    changes = leaf_norms({k: st.p[k] - p0[k] for k in st.p})
    set_tf32(cfg['precision']['tf32'])
    return {'losses': losses, 'grads': grads, 'changes': changes}


def mask_pool(pool: int, n: int, size: int, seed: int, device):
    """{mask name: [pool, n, S, S, 19] float32 one-hot}, each pixel's class
    uniform, drawn on the device."""
    g = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for k in MASKS:
        m = torch.zeros((pool, n, size, size, 19), device=device)
        for i in range(pool):
            label = torch.randint(0, 19, (n, size, size, 1), generator=g,
                                  device=device)
            m[i].scatter_(-1, label, 1.0)
        out[k] = m
    return out


def run(ctx: harness.Context) -> harness.Outcome:
    device, cfg, traffic = ctx.device, ctx.config, ctx.traffic
    ref.check_config(cfg['shape'])
    sc = ShapeConfig(**cfg['shape'])
    n, k_chunk = cfg['batch'], cfg['chunk_size']
    set_tf32(cfg['precision']['tf32'])
    ss = np.random.SeedSequence(ctx.seed)
    w_seed, d_seed, b_seed = (int(x) for x in ss.generate_state(3, np.uint64))

    # ---------------------------------------------------------- set-up
    trainer = ShapeTrainer(sc, device=device, seed=d_seed)
    state = trainer.init_state()
    modules = {fam: getattr(state, part).module for fam, part in PARTS}
    specs = [s for fam, m in modules.items()
             for s in weights.specs_of(m.state_dict(), fam)]
    p0 = weights.draw(specs, w_seed, device)
    for fam, m in modules.items():
        m.load_state_dict(sub(p0, fam), strict=True)
    pool = traffic['pool_batches']
    masks = mask_pool(pool, n, sc.img_size, b_seed, device)

    def make_batch(step):
        return {k: v[step % pool] for k, v in masks.items()}

    def make_draws(step):
        return trainer.draws(step, n)

    runner = ChunkRunner(trainer.train_step, make_batch,
                         make_draws=make_draws)
    first = traffic['first_steps']
    b1 = sc.beta1
    state, rows, trips = runner.run(state, 0, 1, chunk_size=k_chunk,
                                    record_every=1)
    grads = leaf_norms({fam + k: v / (1 - b1) for fam, part in PARTS
                        for k, v in getattr(state, part).mu.items()})
    state, more, t = runner.run(state, 1, first, chunk_size=k_chunk,
                                record_every=1)
    rows, trips = rows + more, trips + t
    with torch.no_grad():
        changes = leaf_norms({fam + k: v - p0[fam + k]
                              for fam, m in modules.items()
                              for k, v in m.named_parameters()})
    prog = {'losses': [tuple(r[k] for k in LOSSES) for r in rows],
            'grads': grads, 'changes': changes}
    first_batches = [{k: v.clone() for k, v in make_batch(i).items()}
                     for i in range(first)]
    first_draws = [make_draws(i) for i in range(first)]
    del p0
    step = first
    t_settled = time.perf_counter() + traffic['settle_seconds']
    while time.perf_counter() < t_settled:
        state, _, t = runner.run(state, step, step + k_chunk,
                                 chunk_size=k_chunk, record_every=k_chunk)
        trips, step = trips + t, step + k_chunk
    window_first = step
    if device.type == 'cuda':
        torch.cuda.synchronize(device)

    # ---------------------------------------------------------- window
    harness.quiet_collector()
    t_start = time.perf_counter()
    setup_s = t_start - ctx.t_process
    tracer = None
    if ctx.trace:
        tracer = Tracer(device)
        with tracer:
            for _ in range(traffic['trace_chunks']):
                state, _, t = runner.run(state, step, step + k_chunk,
                                         chunk_size=k_chunk,
                                         record_every=k_chunk)
                trips, step = trips + t, step + k_chunk
        t_end = t_start + tracer.window_s
    else:
        t_end = t_start
        while t_end - t_start < ctx.seconds:
            state, _, t = runner.run(state, step, step + k_chunk,
                                     chunk_size=k_chunk,
                                     record_every=k_chunk)
            trips, step = trips + t, step + k_chunk
            t_end = time.perf_counter()
    steps = step - window_first
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == 'cuda' else 0
    trace = None
    if ctx.trace:
        trace = tracer.finish({'steps': steps, 'samples': steps * n,
                               'model_flops': steps * flops.step(
                                   cfg['shape'], n)})

    # ------------------------------------------------------ the check
    del runner, state, trainer, modules, masks
    gc.collect()
    if device.type == 'cuda':
        torch.cuda.empty_cache()
    p0 = weights.draw(specs, w_seed, device)
    refr = reference_readings(cfg, p0, first_batches, first_draws)
    skip = excluded(refr['grads'])
    values = compare(prog, refr, skip)
    checks = {k: harness.check(values[k], lim)
              for k, lim in ctx.limits.items()}
    readings = {}
    if ctx.control:
        readings = {'program': values, 'excluded': sorted(skip)}
        for label, kw in (('control_tf32', {'tf32': True}),
                          ('fault_half_batch', {'half': True}),
                          ('fault_r0_first_order',
                           {'r0_first_order': True})):
            got = reference_readings(cfg, p0, first_batches, first_draws,
                                     **kw)
            readings[label] = compare(got, refr, skip)
    return harness.Outcome(
        attempted=steps, failed=trips, checks=checks,
        memory_peak_bytes=peak,
        e2e={'setup_s': setup_s,
             'train_samples_per_s': steps * n / (t_end - t_start)},
        trace=trace, readings=readings)
