"""Temporary checkouts for the benchmark's CPU tests: a copy of
benchmark/ beside a link to the port, BENCHMARK.json with the cells'
configurations cut to a size the CPU runs in seconds, and a launcher that
runs run.main on the CPU (the command line itself refuses to run without
a CUDA device), with faults planted in the program on request."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from typing import Dict, List, Optional

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# widths cut for the CPU: the edit at 64 px ('tiny') or 128 px ('small')
EDIT_SIZES = {
    'tiny': dict(sean=dict(ngf=4, style_dim=16, crop_size=64,
                           zencoder_ngf=4, spade_hidden=8),
                 shape=dict(img_size=64, layer_num=3, max_channel=64,
                            hidden_in_channel=8, face_dim=32),
                 edit_size=64, poisson_iterations=20),
    'small': dict(sean=dict(ngf=16, style_dim=64, crop_size=128,
                            zencoder_ngf=8, spade_hidden=32),
                  shape=dict(img_size=128, layer_num=5, max_channel=256,
                             hidden_in_channel=8, face_dim=128),
                  edit_size=128, poisson_iterations=200),
}

LAUNCHER = '''
import os, sys
ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
fault = os.environ.get('BENCH_TEST_FAULT', '')
audit = os.environ.get('BENCH_TEST_AUDIT', '')
if fault:
    from benchmark.tests import faults
    faults.plant(fault)
if audit:
    from benchmark.tests import faults
    faults.audit_writes(audit.split(os.pathsep))
if os.environ.get('BENCH_TEST_JAX'):
    import types
    sys.modules['jax'] = types.ModuleType('jax')
from benchmark import run
sys.exit(run.main(sys.argv[1:], device='cpu',
                  control=bool(os.environ.get('BENCH_TEST_CONTROL'))))
'''


def edit_config(size: str) -> dict:
    with open(os.path.join(REPO, 'benchmark', 'configs',
                           'ctrlhair_edit.json')) as f:
        cfg = json.load(f)
    p = cfg['pipeline']
    cut = EDIT_SIZES[size]
    p['sean'].update(cut['sean'])
    p['shape'].update(cut['shape'])
    d = cut['sean']['style_dim']
    p['bisenet'].update(input_size=64, blocks_per_stage=1)
    p['color_texture'].update(style_dim=d, g_hidden_dim=16, d_hidden_dim=16)
    p['rgb_predictor'].update(style_dim=d, hidden_dim=16)
    p['curliness_predictor'].update(style_dim=d, hidden_dim=8)
    p['edit_size'] = cut['edit_size']
    p['poisson_iterations'] = cut['poisson_iterations']
    cfg['reduced'] = ['widths cut for the CPU tests']
    return cfg


def train_config() -> dict:
    with open(os.path.join(REPO, 'benchmark', 'configs',
                           'sean_train.json')) as f:
        cfg = json.load(f)
    cfg['sean'].update(ngf=4, style_dim=16, crop_size=64, zencoder_ngf=4,
                       spade_hidden=8)
    cfg['trainer'].update(dis_ndf=8)
    cfg['chunk_size'] = 2
    cfg['reduced'] = ['widths cut for the CPU tests']
    return cfg


def checkout(tmp: str, edit_size: str = 'tiny') -> str:
    """A checkout under tmp: benchmark/ copied, the port linked, the
    manifest's configurations replaced by CPU-sized copies."""
    root = os.path.join(tmp, 'checkout')
    shutil.copytree(os.path.join(REPO, 'benchmark'),
                    os.path.join(root, 'benchmark'),
                    ignore=shutil.ignore_patterns('__pycache__'))
    os.symlink(os.path.join(REPO, 'ctrlhair_tpu_torch'),
               os.path.join(root, 'ctrlhair_tpu_torch'))
    with open(os.path.join(REPO, 'BENCHMARK.json')) as f:
        manifest = json.load(f)
    for c, cfg in (('ctrlhair_edit', edit_config(edit_size)),
                   ('sean_train', train_config())):
        rel = f'benchmark/configs/test_{c}.json'
        write_json(os.path.join(root, rel), cfg)
        for entry in manifest['configs']:
            if entry['name'] == c:
                entry['file'] = rel
    write_json(os.path.join(root, 'BENCHMARK.json'), manifest)
    with open(os.path.join(root, 'cpu_main.py'), 'w') as f:
        f.write(LAUNCHER)
    return root


def write_json(path: str, obj) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, 'w') as f:
        json.dump(obj, f, indent=1)


def run_cell(root: str, workload: str, seed: int = 2 ** 33 + 7,
             seconds: float = 1.5, trace: int = 0,
             env: Optional[Dict[str, str]] = None, cli: bool = False,
             timeout: float = 600) -> subprocess.CompletedProcess:
    """Run one cell in a fresh process from the checkout's root: through
    the CPU launcher, or (cli) through benchmark/run.py itself."""
    script = 'benchmark/run.py' if cli else 'cpu_main.py'
    full_env = dict(os.environ)
    full_env.pop('PYTHONPATH', None)
    full_env.update(env or {})
    return subprocess.run(
        [sys.executable, script, '--workload', workload, '--seed',
         str(seed), '--seconds', str(seconds), '--trace', str(trace)],
        cwd=root, env=full_env, capture_output=True, text=True,
        timeout=timeout)


def last_line(proc: subprocess.CompletedProcess) -> dict:
    lines = [l for l in proc.stdout.splitlines() if l.strip()]
    assert lines, proc.stderr[-3000:]
    return json.loads(lines[-1])


def manifest() -> dict:
    with open(os.path.join(REPO, 'BENCHMARK.json')) as f:
        return json.load(f)


def cells() -> List[str]:
    return [w['name'] for w in manifest()['workloads']]
