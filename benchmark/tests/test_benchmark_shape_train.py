"""The shape.train cell on the CPU at a tiny size (benchmark/tests/
conftest.py cuts its configuration): drivers/shape_train.py reads
`correct` true, and each fault planted in the program
(benchmark/tests/shape_faults.py), or read beside it under the control,
turns it false; the FLOP count of
benchmark/flops/shape_train.py against a count by hand of the port's
passes on the meta device and against the operations a step runs; the
readers of mfu.shape_train, device_idle.shape_train and
inputs_host_ms.train on synthetic traces and span lists, nothing without
the spans."""

import json
import os
import subprocess
import sys
from typing import Dict, NamedTuple, Optional

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from benchmark import peaks, run, spans
from benchmark.flops import shape_train as flops
from benchmark.tests import helpers
from benchmark.tests.conftest import shape_train_config
from benchmark.tests.helpers import last_line, run_cell
from benchmark.trace import Op, Trace

from ctrlhair_tpu_torch.config import ShapeConfig
from ctrlhair_tpu_torch.models.shape import (
    MaskEncoder, ShapeDiscriminator, ShapeDiscriminatorNoise, ShapeGenerator)
from ctrlhair_tpu_torch.training.shape_trainer import (
    ShapeTrainer, synthetic_batch)

CELL = 'shape.train'
LAUNCHER = '''
import os, sys
ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
from benchmark.tests import shape_faults
shape_faults.plant(os.environ['BENCH_TEST_SHAPE_FAULT'])
from benchmark import run
sys.exit(run.main(sys.argv[1:], device='cpu'))
'''


@pytest.fixture(scope='module')
def root(tmp_path_factory):
    root = helpers.checkout(str(tmp_path_factory.mktemp('bench')), 'tiny')
    with open(os.path.join(root, 'cpu_shape_fault.py'), 'w') as f:
        f.write(LAUNCHER)
    return root


def test_correct_on_the_cpu(root):
    proc = run_cell(root, CELL, env={'BENCH_TEST_CONTROL': '1'})
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = last_line(proc)
    assert line['correct'] is True, line['checks']
    assert line['attempted'] > 0 and line['failed'] == 0
    limits = {k: c['limit'] for k, c in line['checks'].items()}
    assert set(limits) == {'loss_gap', 'grad_gap', 'change_gap'}
    # the faults the limits are calibrated against, computed by the
    # reference in the program's place, each fail a limit (TF32, the
    # control, exists only on a card)
    for label in ('fault_half_batch', 'fault_r0_first_order'):
        got = line['readings'][label]
        assert any(got[k] > lim for k, lim in limits.items()), label


@pytest.mark.parametrize('fault', ['shape_unchanged', 'shape_half_batch',
                                   'shape_r0_first_order'])
def test_a_broken_step_is_not_correct(root, fault):
    env = dict(os.environ, BENCH_TEST_SHAPE_FAULT=fault)
    env.pop('PYTHONPATH', None)
    proc = subprocess.run(
        [sys.executable, 'cpu_shape_fault.py', '--workload', CELL, '--seed',
         str(2 ** 33 + 5), '--seconds', '1', '--trace', '0'],
        cwd=root, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = last_line(proc)
    assert line['correct'] is False, line['checks']


# ------------------------------------------------------------ the count
def tiny() -> Dict:
    return shape_train_config()['shape']


def counted(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def test_flops_by_hand():
    sh = tiny()
    cfg, n, s = ShapeConfig(**sh), 4, sh['img_size']
    with torch.device('meta'):
        gen = ShapeGenerator(cfg)
        d, dz = ShapeDiscriminator(cfg), ShapeDiscriminatorNoise(cfg)
        enc = MaskEncoder(cfg, 18, 32, 'ln', hidden_in_channel=16)
        hair = torch.zeros(n, s, s, 1)
        face = torch.zeros(n, s, s, 18)
        codes = torch.zeros(n, sh['hair_dim']), torch.zeros(n, sh['face_dim'])
        by_hand = {
            'hair_encoder': counted(lambda: gen.encode_hair(hair)),
            'face_encoder': counted(lambda: gen.encode_face(face)),
            'hair_decoder': counted(lambda: gen.decode_hair_logit(*codes)),
            'face_decoder': counted(lambda: gen.face_decoder(codes[1])),
            'dis': counted(lambda: d(torch.zeros(n, s, s, 19))),
            'dis_noise': counted(lambda: dz(codes[0])),
        }
        assert flops.encoder(sh, n, 18, 16, 32) == counted(lambda: enc(face))
    for name, value in by_hand.items():
        assert getattr(flops, name)(sh, n) == value, name
    fwd = (2 * by_hand['hair_encoder'] + 2 * by_hand['face_encoder']
           + 3 * by_hand['hair_decoder'] + 2 * by_hand['face_decoder']
           + 4 * by_hand['dis'] + 4 * by_hand['dis_noise'])
    assert flops.forward(sh, n) == fwd
    assert flops.step(sh, n) == 3 * fwd + by_hand['dis'] \
        + by_hand['dis_noise']


class Executed(TorchDispatchMode):
    """The operations of the convolutions and products a block runs,
    forward, backward and double backward alike."""
    total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            shape = lambda x: x.shape if isinstance(x, torch.Tensor) else x
            self.total += count(*tree_map(shape, args),
                                **tree_map(shape, kwargs),
                                out_val=tree_map(shape, out))
        return out


def test_flops_do_not_undercount_the_step():
    """The step runs 0.91 of the count at this size: the backward of D's
    pass in G's loss takes no weight gradient, and no pass's first layer a
    data gradient, which the count's convention charges."""
    sh = tiny()
    cfg = ShapeConfig(**sh)
    tr = ShapeTrainer(cfg, device='cpu', seed=1)
    state = tr.init_state(0)
    batch = synthetic_batch(torch.Generator().manual_seed(2), cfg, 4)
    with Executed() as ex:
        tr.train_step(state, batch, tr.draws(0, 4))
    assert 0.85 * flops.step(sh, 4) <= ex.total <= flops.step(sh, 4)


def test_published_figure():
    """1.125 TFLOP a step at the published widths and batch 4, 93.5 GFLOP
    of forward passes a sample, 80.1 of them the five decodes."""
    with open(os.path.join(helpers.REPO, 'benchmark', 'configs',
                           'shape_train.json')) as f:
        sh = json.load(f)['shape']
    assert round(flops.step(sh, 4) / 1e12, 3) == 1.125
    assert round(flops.forward(sh, 1) / 1e9, 1) == 93.5
    assert round((3 * flops.hair_decoder(sh, 1)
                  + 2 * flops.face_decoder(sh, 1)) / 1e9, 1) == 80.1


# ---------------------------------------------------------- the readers
US = 1000


class Rec(NamedTuple):
    name: str
    request: int
    id: int
    parent: Optional[int]
    thread: int
    start_ns: int
    end_ns: int
    attrs: Dict[str, int]


def rec(name, request, id, parent, start, end, **attrs):
    return Rec(name, request, id, parent, 1, start * US, end * US, attrs)


# two chunks of two steps in the window, a train.inputs nested in another
# (counted once), one chunk of an earlier window
RECORDS = [
    rec('train.chunk', 1, 1, None, 0, 100, steps=2, graph=1),
    rec('train.inputs', 1, 2, 1, 0, 3),
    rec('train.inputs', 1, 3, 1, 50, 52),
    rec('train.chunk', 2, 4, None, 100, 200, steps=2, graph=1),
    rec('train.inputs', 2, 5, 4, 100, 104),
    rec('train.inputs', 2, 6, 5, 101, 103),
    rec('train.inputs', 2, 7, 4, 150, 151),
    rec('train.chunk', 9, 8, None, -900, -800, steps=1, graph=2),
    rec('train.inputs', 9, 9, 8, -900, -890),
]
OPS = [Op('k', 'kernel', 2 * US, 98 * US, None),
       Op('k', 'kernel', 104 * US, 199 * US, None)]


def trace(ops=OPS, steps=4, flop=0):
    return Trace(list(ops), 0.2, [], {'steps': steps, 'samples': 4 * steps,
                                      'model_flops': flop})


def read(name, tr):
    return run.Manifest.reader({'name': name}).read(tr)


def test_inputs_host_ms(monkeypatch):
    monkeypatch.setattr(spans, 'program_records', lambda: list(RECORDS))
    # (3 + 2 + 4 + 1) us over 4 steps
    assert read('inputs_host_ms.train', trace()) == pytest.approx(0.0025)
    assert read('inputs_host_ms.train', trace(steps=0)) is None
    monkeypatch.setattr(spans, 'program_records',
                        lambda: [r for r in RECORDS if r.name != 'train.inputs'])
    assert read('inputs_host_ms.train', trace()) is None
    monkeypatch.setattr(spans, 'program_records', lambda: [])
    assert read('inputs_host_ms.train', trace()) is None


def test_mfu_and_idle():
    flop = 0.2 * peaks.FLOPS['float32'] * 0.25
    assert read('mfu.shape_train', trace(flop=flop)) == pytest.approx(25.0)
    assert read('mfu.shape_train', trace()) is None
    # busy 96 + 95 us of the 0.2 s window
    assert read('device_idle.shape_train', trace()) == pytest.approx(
        100 * (0.2 - 191e-6) / 0.2)
    assert read('device_idle.shape_train', trace(ops=[])) is None
