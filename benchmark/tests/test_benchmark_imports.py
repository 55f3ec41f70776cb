"""What the benchmark imports: nothing of JAX or the JAX package anywhere
under benchmark/, compared by whole top-level names, and nothing of the
port in the yardstick (the reference, the FLOP counts, the metric
readers)."""

import ast
import os
import sys
import types

import pytest

from benchmark import harness
from benchmark.tests.helpers import REPO

BENCH = os.path.join(REPO, 'benchmark')
FORBIDDEN = {'jax', 'jaxlib', 'flax', 'ctrlhair_tpu'}
YARDSTICK = ('reference', 'flops', 'metrics')


def sources():
    for dirpath, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith('.py'):
                yield os.path.join(dirpath, f)


def top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split('.', 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split('.', 1)[0])
    return out


@pytest.mark.parametrize('path', sorted(sources()),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax_or_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize('path', sorted(
    p for p in sources()
    if os.path.relpath(p, BENCH).split(os.sep)[0] in YARDSTICK),
    ids=lambda p: os.path.relpath(p, BENCH))
def test_yardstick_imports_nothing_of_the_port(path):
    assert 'ctrlhair_tpu_torch' not in top_level_imports(path)


def test_forbidden_loaded_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, 'ctrlhair_tpu_torch_fake',
                        types.ModuleType('ctrlhair_tpu_torch_fake'))
    assert 'ctrlhair_tpu' not in harness.forbidden_loaded()
    monkeypatch.setitem(sys.modules, 'ctrlhair_tpu.pipeline',
                        types.ModuleType('ctrlhair_tpu.pipeline'))
    assert 'ctrlhair_tpu' in harness.forbidden_loaded()
