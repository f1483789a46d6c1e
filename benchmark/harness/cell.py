"""A cell's files, found by name, and the state of one run of it.

``BENCHMARK.json`` names each cell's configuration and traffic mix; the
configuration is ``configs/<config>.json``, the mix ``traffic/<traffic>
.json``, the limits of its correctness check ``limits/<workload>.json``,
the code that runs a mix of its kind ``kinds/<kind>.py`` and each metric's
reader ``metrics/<metric>.py``, all under the benchmark's folder. A new
configuration, mix or metric is a new file and a new entry.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Any, Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Cell:
    """One workload of a manifest, with its files."""

    def __init__(self, manifest: Dict, workload: str,
                 bench_dir: str = BENCH_DIR):
        cells = {w['name']: w for w in manifest['workloads']}
        if workload not in cells:
            raise KeyError(f'no workload {workload!r} in BENCHMARK.json '
                           f'(there are {sorted(cells)})')
        self.manifest = manifest
        self.bench_dir = bench_dir
        self.workload = cells[workload]
        self.name = workload
        self.config = load_json(self.path('configs', self.workload['config']))
        self.traffic = load_json(self.path('traffic',
                                           self.workload['traffic']))
        limits = self.path('limits', workload)
        self.limits: Optional[Dict[str, float]] = (
            load_json(limits)['limits'] if os.path.exists(limits) else None)

    def path(self, folder: str, name: str, ext: str = '.json') -> str:
        return os.path.join(self.bench_dir, folder, name + ext)

    def kind(self):
        kind = self.traffic['kind']
        return load_module(self.path('kinds', kind, '.py'),
                           f'bench_kind_{kind}')

    def metrics(self, traced: bool) -> List[Dict]:
        """The cell's end-to-end metrics, or its per-layer ones when
        traced: those whose ``workloads`` list names it, or that have
        none."""
        group = self.manifest['per_layer' if traced else 'end_to_end']
        return [m for m in group
                if 'workloads' not in m or self.name in m['workloads']]

    def reader(self, metric: str):
        return load_module(self.path('metrics', metric, '.py'),
                           f'bench_metric_{metric.replace(".", "_")}')


class Run:
    """What one run of a cell knows: its seed, its clock, whether it is
    traced, and what the kind's code recorded for the metric readers
    (``values``: counts and host times; ``trace``: the traced window)."""

    def __init__(self, cell: Cell, seed: int, seconds: float, traced: bool,
                 clock, device, torch):
        self.cell = cell
        self.config = cell.config
        self.traffic = cell.traffic
        self.seed = seed
        self.seconds = seconds
        self.traced = traced
        self.clock = clock
        self.device = device
        self.torch = torch
        self.values: Dict[str, Any] = {}
        self.trace = None
        self.compared: Dict[str, float] = {}

    # -- the device, whichever it is (the tests run the kinds on the CPU)
    def sync(self) -> None:
        if self.device.type == 'cuda':
            self.torch.cuda.synchronize(self.device)

    def reset_peak(self) -> None:
        if self.device.type == 'cuda':
            self.torch.cuda.reset_peak_memory_stats(self.device)

    def peak_bytes(self) -> int:
        if self.device.type == 'cuda':
            return int(self.torch.cuda.max_memory_allocated(self.device))
        return 0

    def free(self) -> None:
        import gc
        gc.collect()
        if self.device.type == 'cuda':
            self.torch.cuda.empty_cache()

    # -- set-up: build, then a fixed warm-up; printed when it ends
    def end_build(self) -> None:
        self.sync()
        self.clock.mark('built')

    def end_setup(self) -> None:
        self.sync()
        end = self.clock.mark('setup')
        built = self.clock.marks['built']
        self.values.update({'setup.build_s': built,
                            'setup.warm_s': end - built, 'setup_s': end})
        print('setup ' + json.dumps(dict(
            {k: self.values[k] for k in ('setup.build_s', 'setup.warm_s',
                                         'setup_s')},
            marks=self.clock.marks)), flush=True)

    def read_metrics(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for m in self.cell.metrics(self.traced):
            value = self.cell.reader(m['name']).read(self)
            if value is not None:
                out[m['name']] = dict(value=float(value), unit=m['unit'])
        return out
