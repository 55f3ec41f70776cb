"""Readings that the limits of benchmark/limits/ are set from.

    python benchmark/calibrate.py --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...]

Runs the cell once a seed, all in this process, with the control (the
reference computed in the precision below the configuration's, put in
the program's place) and, for training, the planted half-batch fault read
beside the program's numbers.  Each run prints its result line with a
`readings` key; the limits lie above the program's largest reading and
below the smallest of the control's (or a fault's), as PERF.md records.
"""

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seconds', type=float, default=3.0)
    ap.add_argument('--seeds', type=int, nargs='+', required=True)
    args = ap.parse_args(argv)
    for seed in args.seeds:
        rc = run.main(['--workload', args.workload, '--seed', str(seed),
                       '--seconds', str(args.seconds), '--trace', '0'],
                      control=True)
        if rc:
            return rc
    return 0


if __name__ == '__main__':
    sys.exit(main())
