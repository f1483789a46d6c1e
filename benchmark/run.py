"""Runs one cell of the benchmark of fitv2_tpu_torch once.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout that holds ``BENCHMARK.json``. Set-up builds
the cell's model on the card from the seed and warms up its shapes; the
window then runs the cell's work for S seconds; the outputs of the timed
path are compared with the plain reference (benchmark/reference/) once the
window has closed. The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer metrics and ``breakdown``),
``device`` and, last, ``checks``: each compared number beside its limit,
also printed as the last lines of standard error. Exits 2 without a result
where the card or the cell's files are missing, and 3 where a forbidden
package (JAX, flax, the JAX package) was loaded.
"""

from __future__ import annotations

import argparse
import ctypes
import gc
import json
import os
import sys
import threading

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [HERE, ROOT]
# the bytecode of every module a run imports (torch's included), compiled
# once into the checkout: a host that writes no bytecode beside the
# sources would otherwise compile them again in every run's set-up
sys.dont_write_bytecode = False
sys.pycache_prefix = os.path.join(ROOT, '.bench_cache', 'pyc')

from harness import common  # noqa: E402


def _environment() -> None:
    """Fixed host threads and cache folders inside the checkout, before
    torch is imported."""
    for var in ('OMP_NUM_THREADS', 'MKL_NUM_THREADS'):
        os.environ[var] = str(common.HOST_THREADS)
    cache = os.path.join(ROOT, '.bench_cache')
    os.environ['CUDA_CACHE_PATH'] = os.path.join(cache, 'nv')
    os.environ['TRITON_CACHE_DIR'] = os.path.join(cache, 'triton')
    os.environ['TORCH_EXTENSIONS_DIR'] = os.path.join(cache, 'extensions')
    os.environ['USE_FLAX'] = '0'


def _start_cuda_context() -> threading.Thread:
    """Makes device 0's primary CUDA context through libcuda's own API on
    a side thread, while the main thread imports torch: libcuda's calls
    release the GIL, so the two overlap, and torch's runtime then takes
    the context already made. Where anything fails here, torch makes the
    context itself."""
    def make():
        try:
            cuda = ctypes.CDLL('libcuda.so.1')
        except OSError:
            return
        dev, ctx = ctypes.c_int(), ctypes.c_void_p()
        if (cuda.cuInit(0) == 0
                and cuda.cuDeviceGet(ctypes.byref(dev), 0) == 0):
            cuda.cuDevicePrimaryCtxRetain(ctypes.byref(ctx), dev)
    thread = threading.Thread(target=make, name='cuda-context', daemon=True)
    thread.start()
    return thread


def main(argv=None) -> int:
    clock = common.Clock()
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    manifest_path = os.path.join(os.getcwd(), 'BENCHMARK.json')
    if not os.path.exists(manifest_path):
        print(f'no BENCHMARK.json in {os.getcwd()}', file=sys.stderr)
        return 2
    _environment()
    context = _start_cuda_context()
    import torch
    from harness.cell import Cell, Run, load_json
    clock.mark('torch_imported')

    try:
        cell = Cell(load_json(manifest_path), args.workload)
    except (KeyError, OSError) as err:
        print(f'cell {args.workload}: {err}', file=sys.stderr)
        return 2
    chips = int(cell.workload['chips'])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f'{args.workload} needs {chips} CUDA device(s); '
              f'{torch.cuda.device_count() if torch.cuda.is_available() else 0}'
              ' available', file=sys.stderr)
        return 2
    if cell.limits is None:
        print(f'{args.workload}: no limits file', file=sys.stderr)
        return 2
    torch.set_num_threads(common.HOST_THREADS)
    context.join()
    torch.cuda.init()
    torch.empty(1, device='cuda')
    clock.mark('cuda_context')
    run = Run(cell, args.seed, args.seconds, bool(args.trace), clock,
              torch.device('cuda', 0), torch)
    outcome = cell.kind().run(run)
    clock.mark('compared')
    metrics = run.read_metrics()
    gc.collect()
    found = common.forbidden_loaded()
    if found:
        print(f'forbidden modules loaded in this process: {found}',
              file=sys.stderr)
        return 3
    print('compared ' + json.dumps(run.compared), flush=True)
    print('clock ' + json.dumps(clock.marks), flush=True)
    checks = common.judge(run.compared, cell.limits)
    result = dict(correct=common.all_within(checks),
                  attempted=int(outcome['attempted']),
                  failed=int(outcome['failed']), metrics=metrics,
                  device=dict(common.device_record(
                      torch, chips, outcome['memory_peak_bytes']),
                      **outcome.get('device', {})))
    if run.traced and run.trace is not None:
        result['breakdown'] = run.trace.breakdown()
    common.emit(result, checks)
    return 0


if __name__ == '__main__':
    sys.exit(main())
