"""The control that `correct` has to fail: the reference computed in the
precision below the configuration's, put in the program's place.  For the
editor (bfloat16) that is float8, read here on the CPU at 128 px on three
seeds; for SEAN's float32 step it is TF32, which only the card has: that
test carries the cuda marker and runs the cell at its own size."""

import json
import subprocess
import sys

import pytest
import torch

from benchmark.tests import helpers
from benchmark.tests.helpers import last_line, run_cell

SEEDS = (2 ** 32 + 11, 2 ** 32 + 12, 2 ** 32 + 13)


@pytest.fixture(scope='module')
def small(tmp_path_factory):
    return helpers.checkout(str(tmp_path_factory.mktemp('bench')), 'small')


def fails_a_limit(readings, limits, prefix):
    return any(readings[prefix + k] is not None
               and readings[prefix + k] > lim for k, lim in limits.items())


@pytest.mark.parametrize('seed', SEEDS)
def test_float8_editor_is_not_correct(small, seed):
    line = last_line(run_cell(small, 'edit.slider', seed=seed, seconds=4,
                              env={'BENCH_TEST_CONTROL': '1'}))
    assert line['correct'] is True
    limits = {k: v['limit'] for k, v in line['checks'].items()}
    assert fails_a_limit(line['readings'], limits, 'control_')


@pytest.mark.cuda
def test_tf32_training_step_is_not_correct_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: TF32 exists only there')
    seeds = [str(s) for s in SEEDS]
    proc = subprocess.run(
        [sys.executable, 'benchmark/calibrate.py', '--workload',
         'sean.train', '--seconds', '1', '--seeds', *seeds],
        cwd=helpers.REPO, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [l for l in proc.stdout.splitlines() if l.startswith('{')]
    assert len(lines) == len(SEEDS)
    for raw in lines:
        line = json.loads(raw)
        limits = {k: v['limit'] for k, v in line['checks'].items()}
        assert line['correct'] is True
        for label in ('control_tf32', 'fault_half_batch'):
            got = line['readings'][label]
            assert any(got[k] > lim for k, lim in limits.items()), label
