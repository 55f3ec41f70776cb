"""The benchmark of ctrlhair_tpu_torch.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Runs one cell of BENCHMARK.json (at the checkout's root) on the first
CUDA device: builds the cell's program from its configuration file with
weights drawn from the seed, warms up the shapes its traffic uses, drives
the traffic for `--seconds` (with `--trace 1`, a traced window instead),
checks what the timed path produced against the plain reference in
benchmark/reference/, and prints one JSON line as the last line of
standard output.  Everything a cell needs is found by name:
benchmark/traffic/<traffic>.json names its driver
(benchmark/drivers/<driver>.py), benchmark/limits/<cell>.json holds the
limits of its comparison, benchmark/metrics/<metric>.py reads a per-layer
metric from the trace.  Exits with a code other than 0, printing no
result, without a CUDA device, when the manifest or a file it names is
missing, or when JAX or the JAX package was loaded.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402

BENCH_DIR = os.path.join(ROOT, 'benchmark')


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Manifest:
    """BENCHMARK.json and the files it names by cell, configuration,
    traffic and metric."""

    def __init__(self, root: str):
        self.root = root
        self.data = harness.load_json(os.path.join(root, 'BENCHMARK.json'))

    def cell(self, name: str):
        for w in self.data['workloads']:
            if w['name'] == name:
                return w
        raise KeyError(f'no workload {name!r} in BENCHMARK.json')

    def config(self, cell):
        for c in self.data['configs']:
            if c['name'] == cell['config']:
                return harness.load_json(os.path.join(self.root, c['file']))
        raise KeyError(f'no configuration {cell["config"]!r}')

    def traffic(self, cell):
        return harness.load_json(os.path.join(
            BENCH_DIR, 'traffic', cell['traffic'] + '.json'))

    def limits(self, cell):
        return harness.load_json(os.path.join(BENCH_DIR, 'limits',
                                              cell['name'] + '.json'))

    @staticmethod
    def _covers(metric, cell_name: str) -> bool:
        return cell_name in metric.get('workloads', [cell_name])

    def end_to_end(self, cell):
        return [m for m in self.data['end_to_end']
                if self._covers(m, cell['name'])]

    def per_layer(self, cell):
        e2e = {m['name'] for m in self.end_to_end(cell)}

        def reported(m):
            if 'workloads' in m:
                return cell['name'] in m['workloads']
            return m['moves'] in e2e
        return [m for m in self.data['per_layer'] if reported(m)]

    @staticmethod
    def reader(metric):
        name = metric['name']
        return load_module(os.path.join(BENCH_DIR, 'metrics', name + '.py'),
                           'benchmark_metric_' + name.replace('.', '_'))


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def device_entry(device, peak: int, trace) -> dict:
    import torch
    if device.type == 'cuda':
        out = {'platform': 'gpu', 'kind': torch.cuda.get_device_name(device),
               'count': 1, 'memory_peak_bytes': int(peak)}
    else:
        out = {'platform': 'cpu', 'kind': 'cpu', 'count': 1,
               'memory_peak_bytes': int(peak)}
    if trace is not None:
        out['busy_s'] = trace.busy_s()
        out['window_s'] = trace.window_s
    return out


def main(argv=None, device=None, control: bool = False) -> int:
    """Run one cell; returns the exit code.  `device` None takes the first
    CUDA device and refuses to run without one; the tests pass the CPU.
    `control` also reads the control and the planted faults
    (benchmark/calibrate.py)."""
    args = parse_args(argv)
    harness.prepare_environment(ROOT)
    if device is None:
        harness.one_core()
    manifest = Manifest(ROOT)
    try:
        cell = manifest.cell(args.workload)
    except KeyError as e:
        print(e, file=sys.stderr)
        return 2
    import torch
    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell['chips']:
            print(f'{args.workload} needs {cell["chips"]} CUDA device(s); '
                  f'found {torch.cuda.device_count()}', file=sys.stderr)
            return 3
        device = torch.device('cuda', 0)
    device = torch.device(device)
    traffic = manifest.traffic(cell)
    driver = load_module(os.path.join(BENCH_DIR, 'drivers',
                                      traffic['driver'] + '.py'),
                         'benchmark_driver_' + traffic['driver'])
    ctx = harness.Context(
        root=ROOT, workload=args.workload, seed=args.seed,
        seconds=args.seconds, trace=bool(args.trace), cell=cell,
        config=manifest.config(cell), traffic=traffic,
        limits=manifest.limits(cell), device=device,
        t_process=T_PROCESS,
        control=control)
    out = driver.run(ctx)

    found = harness.forbidden_loaded()
    if found:
        print(f'loaded what the benchmark may not load: {found}',
              file=sys.stderr)
        return 4
    metrics = {}
    if args.trace:
        for m in manifest.per_layer(cell):
            value = manifest.reader(m).read(out.trace)
            if value is not None:
                metrics[m['name']] = {'value': value, 'unit': m['unit']}
    else:
        for m in manifest.end_to_end(cell):
            metrics[m['name']] = {'value': out.e2e[m['name']],
                                  'unit': m['unit']}
    line = {'correct': out.correct, 'attempted': out.attempted,
            'failed': out.failed, 'metrics': metrics,
            'device': device_entry(device, out.memory_peak_bytes,
                                   out.trace if args.trace else None)}
    if args.trace:
        line['breakdown'] = out.trace.breakdown()
    if out.readings:
        line['readings'] = out.readings
    line['checks'] = out.checks
    for name, c in out.checks.items():
        print(f'check {name}: {c["value"]!r} (limit {c["limit"]!r})',
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
