"""SEAN's training step through training/chunked.ChunkRunner (its CUDA
graph on the card), on fresh seeded batches.

Set-up builds one SEANTrainer state with weights, VGG19 and the spectral
norm's u vectors drawn from the seed (benchmark/weights.py), fills a pool
of `pool_batches` batches on the device (images uniform in [-1, 1],
labels uniform over the classes: run_sean's synthetic distribution),
and takes the first `first_steps` steps through the runner, the graph
captured on the first.  The window then runs chunks of the
configuration's chunk size until `--seconds` have passed, the clock
stopped by the runner's read of the last chunk's metrics; a traced run
times `trace_chunks` chunks.  Step s takes batch s of the pool, so every
step of a run differs.

The check: the float32 reference (benchmark/reference/sean_train.py)
takes the same first steps from the same weights and batches.  Compared,
each against its limit:
  loss_gap    the larger relative gap of G's and D's loss in the first
              step, where both sides hold the same weights (the later
              steps' losses are read too, as `loss_gap_steps`);
  grad_gap    the first step's gradient (Adam's first moment after one
              step, over 1 - beta1), by the worst leaf: the gap between
              the two norms over the larger of the reference leaf's norm
              and the median leaf's;
  change_gap  the same for each parameter's change over the first steps.
A leaf whose reference gradient is under a thousandth of its model's
median leaf (an ACE's noise scale without noise) is left out of the
last two.
"""

from __future__ import annotations

import gc
import time
from typing import Dict

import numpy as np
import torch

from benchmark import harness, weights
from benchmark.flops import sean_train as flops
from benchmark.reference import sean_train as ref
from benchmark.reference.nn import sub
from benchmark.trace import Tracer

from ctrlhair_tpu_torch.config import SEANConfig
from ctrlhair_tpu_torch.training.chunked import ChunkRunner
from ctrlhair_tpu_torch.training.sean_trainer import SEANTrainer

TRAINER_ARGS = ('lambda_feat', 'lambda_vgg', 'lr_g', 'lr_d', 'use_vgg',
                'dis_num_d', 'dis_ndf', 'dis_n_layers', 'lambda_l1')
EXCLUDE_BELOW = 1e-3


def set_tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = sorted(tensors)
    norms = torch.stack([torch.linalg.vector_norm(tensors[k].double())
                         for k in names]).cpu().tolist()
    return dict(zip(names, norms))


def compare(prog, refr, exclude_grad) -> Dict[str, float]:
    """A run's readings against the reference's: `loss_gap` of the first
    step (G's and D's losses at the same weights), `loss_gap_steps` the
    largest over all the first steps, `grad_gap` and `change_gap`."""
    rel = [max(abs(a - b) / abs(b) for a, b in zip(pa, pb))
           for pa, pb in zip(prog['losses'], refr['losses'])]
    out = {'loss_gap': rel[0], 'loss_gap_steps': max(rel)}
    for key in ('grads', 'changes'):
        worst = 0.0
        for fam in ('sean.', 'dis.'):
            names = [k for k in refr[key] if k.startswith(fam)
                     and k not in exclude_grad]
            med = float(np.median([refr[key][k] for k in names]))
            for k in names:
                worst = max(worst, abs(prog[key][k] - refr[key][k])
                            / max(refr[key][k], med))
        out[key[:-1] + '_gap'] = worst
    return out


def excluded(grads: Dict[str, float]):
    out = set()
    for fam in ('sean.', 'dis.'):
        names = [k for k in grads if k.startswith(fam)]
        med = float(np.median([grads[k] for k in names]))
        out |= {k for k in names if grads[k] < EXCLUDE_BELOW * med}
    return out


def reference_readings(cfg, p0, u0, batches, tf32: bool = False,
                       half: bool = False):
    """The reference's losses, first gradient and change over the first
    steps (`half`: each batch's first half only, the planted fault)."""
    set_tf32(tf32)
    b1 = cfg['trainer']['beta1']
    st = ref.State(p0, u0)
    losses, grads = [], None
    for i, b in enumerate(batches):
        if half:
            b = {k: v[:v.shape[0] // 2] for k, v in b.items()}
        r = ref.step(st, cfg, b)
        losses.append((r['g_total'], r['d_total']))
        if i == 0:
            grads = leaf_norms({k: v / (1 - b1) for k, v in st.mu.items()})
    changes = leaf_norms({k: st.p[k] - p0[k] for k in st.mu})
    set_tf32(cfg['precision']['tf32'])
    return {'losses': losses, 'grads': grads, 'changes': changes}


def run(ctx: harness.Context) -> harness.Outcome:
    device, cfg, traffic = ctx.device, ctx.config, ctx.traffic
    sc = SEANConfig(**cfg['sean'])
    if sc.use_ace_noise:
        raise ValueError('the reference models no ACE noise')
    tr = cfg['trainer']
    n, k_chunk = cfg['batch'], cfg['chunk_size']
    set_tf32(cfg['precision']['tf32'])
    ss = np.random.SeedSequence(ctx.seed)
    w_seed, u_seed, b_seed = (int(x) for x in ss.generate_state(3, np.uint64))

    # ---------------------------------------------------------- set-up
    trainer = SEANTrainer(sc, device=device,
                          **{k: tr[k] for k in TRAINER_ARGS})
    state = trainer.init_state()
    gen, dis = state.gen.module, state.dis.module
    specs = (weights.specs_of(gen.state_dict(), 'sean.')
             + weights.specs_of(dis.state_dict(), 'dis.')
             + weights.specs_of(trainer.vgg.state_dict(), 'vgg.'))
    p0 = weights.draw(specs, w_seed, device)
    gen.load_state_dict(sub(p0, 'sean.'), strict=True)
    dis.load_state_dict(sub(p0, 'dis.'), strict=True)
    trainer.vgg.load_state_dict(sub(p0, 'vgg.'), strict=True)
    u_live = {**{'sean.' + k: v for k, v in state.sn_u.items()},
              **{'dis.' + k: v for k, v in state.dis_sn_u.items()}}
    u_sizes = {k: v.numel() for k, v in u_live.items()}
    with torch.no_grad():
        for k, v in weights.unit_vectors(u_sizes, u_seed, device).items():
            u_live[k].copy_(v)
    pool = traffic['pool_batches']
    s, classes = sc.crop_size, sc.semantic_nc
    g = torch.Generator(device=device).manual_seed(b_seed)
    images = torch.rand((pool, n, s, s, 3), generator=g, device=device)
    images.mul_(2.0).sub_(1.0)
    labels = torch.randint(0, classes, (pool, n, s, s), generator=g,
                           device=device, dtype=torch.int32)

    def make_batch(step):
        return {'image': images[step % pool], 'label': labels[step % pool]}

    runner = ChunkRunner(trainer.train_step, make_batch)
    first = traffic['first_steps']
    b1 = tr['beta1']
    state, rows, trips = runner.run(state, 0, 1, chunk_size=k_chunk,
                                    record_every=1)
    named = lambda fam, d: {fam + k: v for k, v in d.items()}
    grads = leaf_norms({**named('sean.', {k: v / (1 - b1) for k, v in
                                          state.gen.mu.items()}),
                        **named('dis.', {k: v / (1 - b1) for k, v in
                                         state.dis.mu.items()})})
    state, more, t = runner.run(state, 1, first, chunk_size=k_chunk,
                                record_every=1)
    rows, trips = rows + more, trips + t
    live = {**named('sean.', dict(gen.named_parameters())),
            **named('dis.', dict(dis.named_parameters()))}
    with torch.no_grad():
        changes = leaf_norms({k: v - p0[k] for k, v in live.items()})
    prog = {'losses': [(r['g_total'], r['d_total']) for r in rows],
            'grads': grads, 'changes': changes}
    first_batches = [{k: v.clone() for k, v in make_batch(i).items()}
                     for i in range(first)]
    del p0, live
    if device.type == 'cuda':
        torch.cuda.synchronize(device)

    # ---------------------------------------------------------- window
    harness.quiet_collector()
    step = first
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
    steps = step - first
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == 'cuda' else 0
    trace = None
    if ctx.trace:
        trace = tracer.finish({'steps': steps, 'samples': steps * n,
                               'model_flops': steps * flops.step(cfg, n)})

    # ------------------------------------------------------ the check
    del runner, state, trainer, gen, dis, images, labels
    gc.collect()
    if device.type == 'cuda':
        torch.cuda.empty_cache()
    p0 = weights.draw(specs, w_seed, device)
    u0 = weights.unit_vectors(u_sizes, u_seed, device)
    rcfg = {'sean': cfg['sean'], 'trainer': tr,
            'precision': cfg['precision']}
    refr = reference_readings(rcfg, p0, u0, first_batches)
    skip = excluded(refr['grads'])
    values = compare(prog, refr, skip)
    checks = {k: harness.check(values[k], lim)
              for k, lim in ctx.limits.items()}
    readings = {}
    if ctx.control:
        readings = {'program': values, 'excluded': sorted(skip)}
        for label, kw in (('control_tf32', {'tf32': True}),
                          ('fault_half_batch', {'half': True})):
            got = reference_readings(rcfg, p0, u0, first_batches, **kw)
            readings[label] = compare(got, refr, skip)
    return harness.Outcome(
        attempted=steps, failed=trips, checks=checks,
        memory_peak_bytes=peak,
        e2e={'setup_s': setup_s,
             'train_samples_per_s': steps * n / (t_end - t_start)},
        trace=trace, readings=readings)
