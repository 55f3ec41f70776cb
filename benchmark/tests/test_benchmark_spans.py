"""The readers of the program's spans (benchmark/spans.py and the metrics
launch_idle_ms.edit, host_stage_ms.edit, sync_wait_ms.edit): on a
synthetic trace and synthetic records, gaps put down to the outermost
stage, the per-image and per-request divisors, readbacks outside the
requests left out, nothing without images or without the recorder; and
on the CPU, a traced run of each edit cell prints the two readers that
need no device, while an untraced run records nothing."""

import os
import subprocess
import sys
from typing import Dict, NamedTuple, Optional

import pytest

from benchmark import run, spans
from benchmark.tests import helpers
from benchmark.trace import Op, Trace

US = 1000
READERS = ('launch_idle_ms.edit', 'host_stage_ms.edit', 'sync_wait_ms.edit')


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


# request 1: an output (render with a mask decode nested in it, blend,
# readback); 2: a shape slider move; 3: a sweep of 4; 4: a mask read
# outside any request; 9: a request of an earlier window
RECORDS = [
    rec('backend.output', 1, 1, None, 0, 100, images=1),
    rec('render', 1, 2, 1, 10, 50),
    rec('decode_mask', 1, 3, 2, 20, 30),
    rec('blend', 1, 4, 1, 55, 80),
    rec('readback', 1, 5, 1, 82, 98),
    rec('slider.apply', 2, 6, None, 110, 130),
    rec('decode_mask', 2, 7, 6, 112, 128),
    rec('backend.sweep', 3, 8, None, 140, 240, images=4),
    rec('render', 3, 9, 8, 145, 200),
    rec('blend', 3, 10, 8, 200, 220),
    rec('readback', 3, 11, 8, 221, 238),
    rec('readback', 4, 12, None, 100, 105),
    rec('backend.output', 9, 13, None, -5000, -4000, images=1),
    rec('render', 9, 14, 13, -4900, -4100),
]


def op(start, end):
    return Op('k', 'kernel', start * US, end * US, None)


# gaps begin at 15 (render, 10), 52 (no stage, 8), 70 (blend, 45),
# 125 (decode_mask of the slider move, 25), 210 (blend, 20)
OPS = [op(0, 15), op(25, 52), op(60, 70), op(115, 125), op(150, 210),
       op(230, 235)]
HARNESS = [('request', 0, 100 * US), ('request', 110 * US, 130 * US),
           ('request', 140 * US, 240 * US)]


def read(name, trace):
    return run.Manifest.reader({'name': name}).read(trace)


@pytest.fixture
def records(monkeypatch):
    monkeypatch.setattr(spans, 'program_records', lambda: list(RECORDS))


def test_gaps_go_to_the_outermost_stage(records):
    w = spans.Window(Trace(OPS, 0.3e-3, HARNESS, {}))
    assert [r.request for r in w.roots] == [1, 2, 3]
    assert w.images == 5 and w.image_requests == 2
    assert [r.id for r in w.stages] == [2, 4, 7, 9, 10]
    assert w.idle_by_stage(OPS) == {'render': 10 * US, 'blend': 65 * US,
                                    'decode_mask': 25 * US}


def test_readers_and_their_divisors(records):
    trace = Trace(OPS, 0.3e-3, HARNESS, {})
    # 100 us of idle over 5 images
    assert read('launch_idle_ms.edit', trace) == pytest.approx(0.02)
    # stages 40 + 25 + 16 + 55 + 20 us over 5 images; the nested decode
    # and the earlier window's render left out
    assert read('host_stage_ms.edit', trace) == pytest.approx(0.0312)
    # readbacks 16 + 17 us over the 2 requests with images; the mask read
    # outside any request left out
    assert read('sync_wait_ms.edit', trace) == pytest.approx(0.0165)


def test_agrees_with_the_harness_spans_on_the_same_gaps(records):
    """Harness spans around the same stages give Trace.breakdown's idle
    gaps the same split."""
    stages = [(r.name, r.start_ns, r.end_ns) for r in RECORDS
              if r.name in spans.STAGES and r.id not in (3, 14)]
    harness_spans = sorted(HARNESS + stages, key=lambda s: s[1])
    trace = Trace(OPS, 0.3e-3, harness_spans, {})
    gaps = dict(trace.breakdown()['idle_gaps'])
    w = spans.Window(trace)
    for name, ns in w.idle_by_stage(OPS).items():
        assert gaps[name] == pytest.approx(ns / 1e9)


def test_nothing_to_read(monkeypatch):
    trace = Trace(OPS, 0.3e-3, HARNESS, {})
    no_images = [r for r in RECORDS if r.request == 2]
    for recs in ([], no_images):
        monkeypatch.setattr(spans, 'program_records', lambda: list(recs))
        for name in READERS:
            assert read(name, trace) is None
    monkeypatch.setattr(spans, 'program_records', lambda: list(RECORDS))
    assert read('launch_idle_ms.edit', Trace([], 0.3e-3, HARNESS, {})) \
        is None
    assert read('host_stage_ms.edit', Trace([], 0.3e-3, HARNESS, {})) > 0


def test_a_program_without_the_recorder_gives_nothing(monkeypatch):
    from ctrlhair_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, 'records')
    assert spans.program_records() == []
    for name in READERS:
        assert read(name, Trace(OPS, 0.3e-3, HARNESS, {})) is None


LAUNCHER = '''
import os, sys
ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
from benchmark import run
rc = run.main(sys.argv[1:], device='cpu')
from ctrlhair_tpu_torch.utils import profiling
print(f'SPAN_RECORDS {len(profiling.records())}', file=sys.stderr)
sys.exit(rc)
'''


@pytest.fixture(scope='module')
def root(tmp_path_factory):
    root = helpers.checkout(str(tmp_path_factory.mktemp('bench')), 'tiny')
    with open(os.path.join(root, 'spans_main.py'), 'w') as f:
        f.write(LAUNCHER)
    return root


@pytest.mark.parametrize('trace', [0, 1])
@pytest.mark.parametrize('cell', ['edit.slider', 'edit.sweep8'])
def test_cpu_run_of_an_edit_cell(root, cell, trace):
    env = dict(os.environ)
    env.pop('PYTHONPATH', None)
    proc = subprocess.run(
        [sys.executable, 'spans_main.py', '--workload', cell, '--seed',
         str(2 ** 33 + 11), '--seconds', '1.5', '--trace', str(trace)],
        cwd=root, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = helpers.last_line(proc)
    assert line['correct'] is True, line['checks']
    count = int(proc.stderr.rsplit('SPAN_RECORDS ', 1)[1].split()[0])
    if not trace:
        assert count == 0
        return
    assert count > 0
    for name in ('host_stage_ms.edit', 'sync_wait_ms.edit'):
        m = line['metrics'][name]
        assert isinstance(m['value'], float) and m['value'] > 0
        assert m['unit'] == 'ms'
    # no device operation on the CPU
    assert 'launch_idle_ms.edit' not in line['metrics']
