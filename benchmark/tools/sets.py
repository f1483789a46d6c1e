"""Runs one cell several times, each run a process of its own, and prints
each run's result line and, per metric, the median and the spread (the
interquartile distance over the median, Python's
``statistics.quantiles(values, n=4)``), the measure the bounds are set
from:

    python3 benchmark/tools/sets.py --workload NAME --seeds S1,S2,...
        [--seconds N] [--trace 0|1]

From the root of a checkout, on the machine with the card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from typing import Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from harness.cell import load_json  # noqa: E402
from harness.common import spread  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', required=True)
    ap.add_argument('--seconds', type=float, default=None)
    ap.add_argument('--trace', type=int, default=0)
    args = ap.parse_args(argv)
    seconds = args.seconds or load_json('BENCHMARK.json')['run_seconds']
    values: Dict[str, List[float]] = {}
    for seed in args.seeds.split(','):
        proc = subprocess.run(
            [sys.executable, os.path.join(os.path.dirname(HERE), 'run.py'),
             '--workload', args.workload, '--seed', seed, '--seconds',
             str(seconds), '--trace', str(args.trace)],
            capture_output=True, text=True)
        lines = proc.stdout.strip().splitlines()
        for line in lines[:-1]:
            if line.startswith(('setup ', 'clock ', 'compared ')):
                print(f'{seed} {line}', flush=True)
        if proc.returncode or not lines:
            print(f'{seed} rc={proc.returncode} {proc.stderr[-2000:]}',
                  flush=True)
            continue
        result = json.loads(lines[-1])
        print(f'{seed} {lines[-1]}', flush=True)
        for name, m in result['metrics'].items():
            values.setdefault(name, []).append(m['value'])
        values.setdefault('correct', []).append(float(result['correct']))
    summary = {name: dict(median=statistics.median(v),
                          spread=spread(v) if len(v) >= 2 else None,
                          values=v)
               for name, v in values.items()}
    print('summary ' + json.dumps(summary), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
