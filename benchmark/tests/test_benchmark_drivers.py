"""Each driver end to end on the CPU at a tiny size, through run.main in
a fresh process from a temporary checkout: the last line's form, a cell,
a configuration and a per-layer metric added as files only, the faults
that must turn `correct` false, where a run writes, and the refusals
(no CUDA device, no program beside the benchmark, JAX loaded)."""

import json
import os
import shutil

import pytest
import torch

from benchmark.tests import helpers
from benchmark.tests.helpers import last_line, run_cell

CELLS = helpers.cells()


@pytest.fixture(scope='module')
def root(tmp_path_factory):
    return helpers.checkout(str(tmp_path_factory.mktemp('bench')), 'tiny')


def expected_metrics(cell, trace):
    m = helpers.manifest()
    if trace:
        return {p['name'] for p in m['per_layer']
                if cell in p.get('workloads', [])}
    return {e['name'] for e in m['end_to_end']
            if cell in e.get('workloads', [cell])}


@pytest.mark.parametrize('trace', [0, 1])
@pytest.mark.parametrize('cell', CELLS)
def test_cell_runs_and_prints_its_line(root, cell, trace):
    proc = run_cell(root, cell, trace=trace)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = last_line(proc)
    assert list(line)[:5] == ['correct', 'attempted', 'failed', 'metrics',
                              'device']
    assert list(line)[-1] == 'checks'
    assert line['correct'] is True, line['checks']
    assert line['failed'] == 0 and line['attempted'] > 0
    got = set(line['metrics'])
    want = expected_metrics(cell, trace)
    if trace:
        # on the CPU no device operation is traced: only the readers that
        # need none report
        assert got <= want
        assert {'busy_s', 'window_s'} <= set(line['device'])
        assert set(line['breakdown']) == {'device_ops', 'idle_gaps'}
    else:
        assert got == want
    for name, m in line['metrics'].items():
        assert isinstance(m['value'], float) and m['unit']
    tail = proc.stderr.strip().splitlines()[-len(line['checks']):]
    for name, c in line['checks'].items():
        assert c['value'] <= c['limit']
        assert any(l.startswith(f'check {name}: ') for l in tail)


def test_added_as_files_only(tmp_path):
    """A new configuration, traffic, cell and per-layer metric, each only
    a file and a manifest entry, are found and run."""
    root = helpers.checkout(str(tmp_path), 'tiny')
    bench = os.path.join(root, 'benchmark')
    with open(os.path.join(bench, 'configs', 'test_ctrlhair_edit.json')) \
            as f:
        cfg = json.load(f)
    cfg['pipeline']['poisson_iterations'] = 30
    helpers.write_json(os.path.join(bench, 'configs', 'edit_b.json'), cfg)
    with open(os.path.join(bench, 'traffic', 'slider_closed_loop.json')) \
            as f:
        traffic = json.load(f)
    traffic.update(run_length=4, trace_requests=12)
    helpers.write_json(os.path.join(bench, 'traffic', 'slider_short.json'),
                       traffic)
    with open(os.path.join(bench, 'limits', 'edit.slider.json')) as f:
        limits = json.load(f)
    helpers.write_json(os.path.join(bench, 'limits', 'edit_b.slider.json'),
                       limits)
    with open(os.path.join(bench, 'metrics', 'busy_ms.edit_b.py'), 'w') as f:
        f.write('def read(trace):\n    return trace.busy_s() * 1e3\n')
    path = os.path.join(root, 'BENCHMARK.json')
    with open(path) as f:
        m = json.load(f)
    m['configs'].append({'name': 'edit_b', 'source': 'https://example.org',
                         'file': 'benchmark/configs/edit_b.json',
                         'reduced': [], 'why': 'a test configuration'})
    m['workloads'].append({'name': 'edit_b.slider', 'config': 'edit_b',
                           'traffic': 'slider_short', 'chips': 1,
                           'why': 'a test cell'})
    for e in m['end_to_end']:
        if 'workloads' in e and 'edit.slider' in e['workloads']:
            e['workloads'].append('edit_b.slider')
    m['per_layer'].append({'name': 'busy_ms.edit_b', 'unit': 'ms',
                           'better': 'lower', 'source': 'device_trace',
                           'layer': 'device', 'moves': 'images_per_s',
                           'workloads': ['edit_b.slider']})
    helpers.write_json(path, m)
    line = last_line(run_cell(root, 'edit_b.slider', trace=0))
    assert line['correct'] and set(line['metrics']) == {
        'images_per_s', 'setup_s'}
    line = last_line(run_cell(root, 'edit_b.slider', trace=1))
    assert line['attempted'] == 12
    assert line['metrics']['busy_ms.edit_b']['unit'] == 'ms'


@pytest.mark.parametrize('cell, fault', [
    ('edit.slider', 'slider_unchanged'),
    ('edit.slider', 'answer_altered'),
    ('edit.sweep8', 'sweep_half_batch'),
    ('edit.sweep8', 'answer_altered'),
    ('sean.train', 'train_unchanged'),
    ('sean.train', 'train_half_batch'),
])
def test_a_broken_timed_path_is_not_correct(root, cell, fault):
    proc = run_cell(root, cell, seconds=3,
                    env={'BENCH_TEST_FAULT': fault})
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = last_line(proc)
    assert line['correct'] is False, line['checks']


def test_writes_only_inside_the_allowed_directories(root, tmp_path):
    dirs = {k: str(tmp_path / k) for k in ('HOME', 'XDG_CACHE_HOME',
                                           'TMPDIR')}
    for d in dirs.values():
        os.makedirs(d)
    env = dict(dirs, BENCH_TEST_AUDIT=os.pathsep.join(
        [root] + list(dirs.values())))
    for cell in CELLS:
        proc = run_cell(root, cell, env=env)
        assert proc.returncode == 0, proc.stderr[-3000:]
        assert 'WRITE OUTSIDE' not in proc.stderr


def test_refuses_without_a_cuda_device(root):
    if torch.cuda.is_available():
        pytest.skip('this host has a CUDA device')
    proc = run_cell(root, CELLS[0], cli=True)
    assert proc.returncode != 0 and not proc.stdout.strip()


def test_refuses_without_the_program(tmp_path):
    bare = str(tmp_path / 'bare')
    os.makedirs(bare)
    shutil.copytree(os.path.join(helpers.REPO, 'benchmark'),
                    os.path.join(bare, 'benchmark'),
                    ignore=shutil.ignore_patterns('__pycache__'))
    shutil.copy(os.path.join(helpers.REPO, 'BENCHMARK.json'), bare)
    with open(os.path.join(bare, 'cpu_main.py'), 'w') as f:
        f.write(helpers.LAUNCHER)
    for cli in (True, False):
        proc = run_cell(bare, CELLS[0], cli=cli)
        assert proc.returncode != 0 and not proc.stdout.strip()


def test_refuses_when_jax_is_loaded(root):
    proc = run_cell(root, CELLS[0], env={'BENCH_TEST_JAX': '1'})
    assert proc.returncode != 0 and not proc.stdout.strip()
    assert 'jax' in proc.stderr
