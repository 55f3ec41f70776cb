"""BENCHMARK.json against the rules a manifest keeps: keys, names and
units, which metric each cell reports, the files each entry names, the
bounds and the time a full check takes."""

import json
import os
import re

import pytest

from benchmark.tests.helpers import REPO, manifest

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.\-]{1,16}$')
LINE = re.compile(r'^[^\n\t]{1,200}$')
KEYS = {'command', 'paths', 'run_seconds', 'configs', 'workloads',
        'end_to_end', 'per_layer'}


def e2e_of(m, cell):
    return {e['name'] for e in m['end_to_end']
            if cell in e.get('workloads', [cell])}


def test_top_level_keys_and_size():
    path = os.path.join(REPO, 'BENCHMARK.json')
    assert os.path.getsize(path) <= 64 * 1024
    m = manifest()
    assert set(m) == KEYS
    assert m['command'][:2] == ['python3', 'benchmark/run.py']
    assert len(m['command']) <= 32
    for p in m['paths']:
        assert re.match(r'^[A-Za-z0-9_.\-/]{1,200}$', p) and '..' not in p
        assert os.path.isdir(os.path.join(REPO, p))
    assert 1 <= m['run_seconds'] <= 51


@pytest.mark.parametrize('section', ['configs', 'workloads', 'end_to_end',
                                     'per_layer'])
def test_names_and_units(section):
    m = manifest()
    names = [e['name'] for e in m[section]]
    assert len(names) == len(set(names))
    for e in m[section]:
        assert NAME.match(e['name']), e['name']
        if 'unit' in e:
            assert UNIT.match(e['unit']), e['unit']
            assert e['better'] in ('lower', 'higher')
        for key in ('why', 'layer'):
            if key in e:
                assert LINE.match(e[key]), e[key]
        if section == 'configs':
            assert LINE.match(e['source'])


def test_entry_keys():
    m = manifest()
    for c in m['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        assert c['file'].startswith('benchmark/')
        assert os.path.isfile(os.path.join(REPO, c['file']))
        assert len(c['reduced']) <= 16
    for w in m['workloads']:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
        assert w['chips'] in (1, 4)
        assert NAME.match(w['traffic']) and NAME.match(w['config'])
    for e in m['end_to_end']:
        assert set(e) - {'workloads'} == {'name', 'unit', 'better', 'bound',
                                          'source'}
        assert e['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= e['bound'] <= 0.25
    for e in m['per_layer']:
        assert set(e) - {'workloads'} == {'name', 'unit', 'better', 'source',
                                          'layer', 'moves'}
        assert e['source'] in ('device_trace', 'program_span',
                               'program_counter', 'host_clock')
    pairs = [(w['config'], w['traffic']) for w in m['workloads']]
    assert len(pairs) == len(set(pairs))
    four = sum(w['chips'] == 4 for w in m['workloads'])
    assert four <= max(1, len(m['workloads']) // 4)


def test_every_cell_reports_what_it_must():
    m = manifest()
    configs = {c['name'] for c in m['configs']}
    assert configs == {w['config'] for w in m['workloads']}
    for w in m['workloads']:
        e2e = e2e_of(m, w['name'])
        assert 'setup_s' in e2e and len(e2e) >= 2, w['name']
        layer = [p for p in m['per_layer']
                 if w['name'] in p.get('workloads', [])
                 or ('workloads' not in p and p['moves'] in e2e)]
        assert layer, w['name']


def test_metric_workloads_and_moves_agree():
    m = manifest()
    cells = {w['name'] for w in m['workloads']}
    e2e_names = {e['name'] for e in m['end_to_end']}
    layers = {}
    for p in m['per_layer']:
        assert p['moves'] in e2e_names
        for cell in p.get('workloads', []):
            assert cell in cells
            assert p['moves'] in e2e_of(m, cell), (p['name'], cell)
        layers.setdefault(p['name'].split('.')[0], set()).add(p['layer'])
    for e in m['end_to_end']:
        for cell in e.get('workloads', []):
            assert cell in cells


def test_every_named_file_exists():
    m = manifest()
    bench = os.path.join(REPO, 'benchmark')
    for w in m['workloads']:
        with open(os.path.join(bench, 'traffic', w['traffic'] + '.json')) \
                as f:
            traffic = json.load(f)
        assert os.path.isfile(os.path.join(bench, 'drivers',
                                           traffic['driver'] + '.py'))
        with open(os.path.join(bench, 'limits', w['name'] + '.json')) as f:
            limits = json.load(f)
        assert limits and all(v > 0 for v in limits.values())
    for p in m['per_layer']:
        assert os.path.isfile(os.path.join(bench, 'metrics',
                                           p['name'] + '.py'))


def test_a_full_check_fits_its_time():
    """2 + 14 x cells runs of run_seconds + 60 s, 2 x 90 s a cell to
    compile and 1200 s spare, with the 24 cells a manifest may hold."""
    s = manifest()['run_seconds']
    cells = 24
    total = (2 + 14 * cells) * (s + 60) + cells * 2 * 90 + 1200
    assert total <= 43200
