"""The readings that a cell's correctness limits are set from, at the cell's
own size, on the card:

    python3 benchmark/tools/readings.py --workload NAME --seeds S1,S2,...
        [--control-seeds C1,C2,C3]

For each seed the program runs the cell's timed path once (one batch of
the window's sampler) and the plain reference recomputes the rows the
cell compares: the program's readings, the lower end of each limit. For
each control seed the reference in float8 (reference/lowp.py) is compared
with the float32 reference instead: the control's readings, the upper
end. One JSON line per reading. Runs from the root of a checkout.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]

from harness.cell import Cell, Run, load_json  # noqa: E402
from harness.common import Clock, full_fp32  # noqa: E402
from harness.compare import image_gaps  # noqa: E402


def sample_reading(run, kind, lowp: bool):
    _, rows = kind.compared_rows(run, 1)
    if not lowp:
        from harness import traffic
        model, vae, sampler, warm = kind.build(run)
        labels, z = traffic.sample_batch(run.traffic, run.config, run.seed,
                                         0, run.device)
        other = sampler(labels, z=z).cpu().numpy()[rows]
        del model, vae, sampler, warm
        run.free()
    with full_fp32(run.torch):
        ref = kind.reference_images(run, 0, rows)
        if lowp:
            other = kind.reference_images(run, 0, rows, lowp=True)
    return image_gaps(other, ref, 8 * run.config['model']['patch_size'])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', default='')
    ap.add_argument('--control-seeds', default='')
    args = ap.parse_args(argv)
    import torch
    cell = Cell(load_json(os.path.join(os.getcwd(), 'BENCHMARK.json')),
                args.workload)
    kind = cell.kind()
    plan = ([('program', int(s)) for s in args.seeds.split(',') if s]
            + [('control', int(s)) for s in args.control_seeds.split(',') if s])
    for what, seed in plan:
        t0 = time.time()
        run = Run(cell, seed, 0.0, False, Clock(), torch.device('cuda', 0),
                  torch)
        gaps = sample_reading(run, kind, what == 'control')
        run.free()
        print(json.dumps(dict(workload=cell.name, reading=what, seed=seed,
                              seconds=round(time.time() - t0, 1), **gaps)),
              flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
