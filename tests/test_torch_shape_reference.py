# The port's shape trainer (054: training/shape_trainer.py) through
# training/chunked.ChunkRunner against the benchmark's plain reference of
# the same step (benchmark/reference/shape_train.py), on the CPU at 32 px,
# 3 layers, 32 channels, a 64-d face code and batch 4, the weights drawn by
# benchmark/weights.py into both and the trainer's own host draws handed to
# the reference: the losses of the first step, every leaf's first gradient
# and its change over three steps, with both sides in float64 and in
# float32; and the two faults that the shape.train cell's limits are
# calibrated against (D's R0 input gradient taken first-order only, each
# batch's first half) each move D's gradient past the float32 bar.
import dataclasses

import numpy as np
import pytest
import torch

from benchmark import weights
from benchmark.reference import shape_train as ref
from benchmark.reference.nn import sub
from ctrlhair_tpu_torch.config import ShapeConfig
from ctrlhair_tpu_torch.models.layers import set_compute_dtype
from ctrlhair_tpu_torch.training.chunked import ChunkRunner
from ctrlhair_tpu_torch.training.shape_trainer import ShapeTrainer

CFG = ShapeConfig(img_size=32, layer_num=3, max_channel=32, face_dim=64)
PARTS = (('gen.', 'gen'), ('dis.', 'dis'), ('dis_noise.', 'dis_noise'))
STEPS, BATCH, SEED = 3, 4, 2 ** 33 + 19
B1 = CFG.beta1


def batches(dtype):
    g = torch.Generator().manual_seed(11)
    s = CFG.img_size
    return [{k: torch.nn.functional.one_hot(
        torch.randint(0, 19, (BATCH, s, s), generator=g), 19).to(dtype)
        for k in ('target', 'face', 'hair', 'real')} for _ in range(STEPS)]


def port(dtype):
    """The port's losses (rows), first gradients and three-step changes,
    every model computing in `dtype`."""
    tr = ShapeTrainer(CFG, device='cpu', seed=7)
    state = tr.init_state()
    specs = [s for fam, part in PARTS for s in weights.specs_of(
        getattr(state, part).module.state_dict(), fam)]
    p0 = weights.draw(specs, SEED, 'cpu')
    for fam, part in PARTS:
        mo = getattr(state, part)
        mo.module.load_state_dict(sub(p0, fam))
        mo.module.to(dtype)
        set_compute_dtype(mo.module, dtype)
        mo.mu = {k: torch.zeros_like(v)
                 for k, v in mo.module.named_parameters()}
        mo.nu = {k: torch.zeros_like(v)
                 for k, v in mo.module.named_parameters()}
    bs = batches(dtype)
    draws = [{k: v.to(dtype) if v.is_floating_point() else v
              for k, v in tr.draws(i, BATCH).items()} for i in range(STEPS)]
    runner = ChunkRunner(tr.train_step, lambda i: bs[i],
                         make_draws=lambda i: draws[i])
    state, rows, trips = runner.run(state, 0, 1, chunk_size=2,
                                    record_every=1)
    grads = {fam + k: v / (1 - B1) for fam, part in PARTS
             for k, v in getattr(state, part).mu.items()}
    state, more, t = runner.run(state, 1, STEPS, chunk_size=2,
                                record_every=1)
    assert trips + t == 0
    changes = {fam + k: v.detach() - p0[fam + k].to(dtype)
               for fam, part in PARTS
               for k, v in getattr(state, part).module.named_parameters()}
    return {'rows': rows + more, 'grads': grads, 'changes': changes,
            'p0': p0, 'batches': bs, 'draws': draws}


def reference(p, dtype, **fault):
    """The reference's losses, first gradients and changes from the same
    weights, batches and draws.  In float64 it takes the loss weights as
    float32 holds them, as the port's schedule (training/losses.
    LossSchedule) sums its terms in float32: lambda_kl is then 0.1 rounded
    to float32 on both sides."""
    cfg = dataclasses.asdict(CFG)
    if dtype == torch.float64:
        cfg.update({k: float(np.float32(v)) for k, v in cfg.items()
                    if k.startswith('lambda_') and isinstance(v, float)})
    st = ref.State({k: v.to(dtype) for k, v in p['p0'].items()})
    rows, grads = [], None
    for i, (b, d) in enumerate(zip(p['batches'], p['draws'])):
        if fault.get('half'):
            b = {k: v[:BATCH // 2] for k, v in b.items()}
            d = {k: v[:BATCH // 2] if v.dim() else v for k, v in d.items()}
        rows.append(ref.step(st, cfg, b, d,
                             r0_first_order=fault.get('r0_first_order',
                                                      False)))
        if i == 0:
            grads = {k: v / (1 - B1) for k, v in st.mu.items()}
    changes = {k: st.p[k] - p['p0'][k].to(dtype) for k in st.p}
    return {'rows': rows, 'grads': grads, 'changes': changes}


@pytest.fixture(scope='module')
def float64():
    p = port(torch.float64)
    return p, reference(p, torch.float64)


@pytest.fixture(scope='module')
def float32():
    p = port(torch.float32)
    return p, reference(p, torch.float32)


def leaf_gap(a, b) -> float:
    """The largest entry of |a - b| over the largest of |b|."""
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def worst(got, want, names=None):
    names = sorted(want) if names is None else names
    return max((leaf_gap(got[k], want[k]), k) for k in names)


def relative(a, b) -> float:
    return abs(a - b) / abs(b)


# float64 on both sides: each term of the losses, each gradient and each
# change agrees to float64 rounding (read: 2.6e-16 for the terms, 9.5e-16
# and 3.5e-13 of a leaf's largest entry for the gradients and the changes),
# so 1e-9 leaves a thousand times of room and still catches any difference
# of arithmetic.  G's and D's totals are the port's float32 sums of the
# weighted terms (LossSchedule.total): within 1e-6, the bound of seven
# float32 products and additions, each rounding by up to 2^-24 (read:
# 1.6e-7).
def test_float64_losses(float64):
    p, r = float64
    for got, want in zip(p['rows'], r['rows']):
        for k in want:
            if k.startswith('g/') or k == 'dz_total':
                assert relative(got[k], want[k]) <= 1e-9, k
            else:
                assert relative(got[k], want[k]) <= 1e-6, k


@pytest.mark.parametrize('key', ['grads', 'changes'])
def test_float64_leaves(float64, key):
    p, r = float64
    assert set(p[key]) == set(r[key])
    gap, name = worst(p[key], r[key])
    assert gap <= 1e-9, (name, gap)


# float32 on both sides, the same operations in another order here and
# there: the losses within 1e-6 (read: 0 at this seed, up to 1.8e-7 over
# three steps at others), each first gradient within 1e-4 of its leaf's
# largest entry (read: 9.5e-7; 1.6e-6 at another seed).  Adam's first
# steps move an entry by about lr x the sign of its gradient, so an entry
# whose gradient rounds across zero moves the other way (read: 1.5e-4 of
# a leaf's largest change): the changes are held as the cell holds them,
# by the norm of each leaf, within 1e-4 of the larger of the reference
# leaf's norm and its family's median (read: 2.9e-7).
FLOAT32_GRAD_BAR = 1e-4


def test_float32_losses(float32):
    p, r = float32
    for got, want in zip(p['rows'], r['rows']):
        for k in ('g_total', 'd_total', 'dz_total'):
            assert relative(got[k], want[k]) <= 1e-6, k


def test_float32_gradients(float32):
    p, r = float32
    gap, name = worst(p['grads'], r['grads'])
    assert gap <= FLOAT32_GRAD_BAR, (name, gap)


def norm_gap(got, want) -> float:
    norm = lambda t: float(torch.linalg.vector_norm(t.double()))
    out = 0.0
    for fam, _ in PARTS:
        names = [k for k in want if k.startswith(fam)]
        med = float(np.median([norm(want[k]) for k in names]))
        out = max(out, max(abs(norm(got[k]) - norm(want[k]))
                           / max(norm(want[k]), med) for k in names))
    return out


def test_float32_changes(float32):
    p, r = float32
    assert norm_gap(p['changes'], r['changes']) <= 1e-4


@pytest.mark.parametrize('fault', ['r0_first_order', 'half'])
def test_a_planted_fault_moves_d_past_the_bar(float32, fault):
    """Either fault moves some leaf of D's first gradient by far more than
    the float32 bar (read: 0.96 and 0.95 of its largest entry)."""
    p, r = float32
    bad = reference(p, torch.float32, **{fault: True})
    dis = [k for k in r['grads'] if k.startswith('dis.')]
    gap, _ = worst(bad['grads'], r['grads'], dis)
    assert gap > 100 * FLOAT32_GRAD_BAR
