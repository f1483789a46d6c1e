"""What every cell shares: seeds, the set-up clock, statistics, the device
record, the result line and its checks."""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import sys
import time
from typing import Dict, List, Sequence

import numpy as np

# the host's intra-op threads in every run, whatever the host offers
HOST_THREADS = 4
# top-level module names that may not be loaded in a run
FORBIDDEN_MODULES = ('jax', 'jaxlib', 'flax', 'fitv2_tpu')
GIB = float(1 << 30)


def process_age_s() -> float:
    """Seconds since this process started (0 where /proc is absent)."""
    try:
        with open('/proc/self/stat') as f:
            fields = f.read().rsplit(')', 1)[1].split()
        with open('/proc/uptime') as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - int(fields[19]) / os.sysconf('SC_CLK_TCK'))
    except (OSError, ValueError, IndexError):
        return 0.0


def derive_seed(seed: int, *words: int) -> int:
    """A 63-bit seed from the run's seed and integer words."""
    state = np.random.SeedSequence([int(seed), *map(int, words)])
    return int(state.generate_state(1, np.uint64)[0] >> np.uint64(1))


# words that keep the seeded streams apart
WEIGHTS, VAE_WEIGHTS, INPUTS, SAMPLE_ROWS = range(4)


def spread(values: Sequence[float]) -> float:
    """Interquartile distance over the median, as the benchmark's bounds are
    set: Python's ``statistics.quantiles(values, n=4)``."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


class Clock:
    """The run's host clock, zero at the process's start."""

    def __init__(self):
        self.base = time.perf_counter() - process_age_s()
        self.marks: Dict[str, float] = {}

    def now(self) -> float:
        return time.perf_counter() - self.base

    def mark(self, name: str) -> float:
        self.marks[name] = self.now()
        return self.marks[name]


@contextlib.contextmanager
def full_fp32(torch):
    """float32 products without TF32, for the reference; the flags as they
    were afterwards."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def forbidden_loaded() -> List[str]:
    return sorted({m.split('.')[0] for m in sys.modules}
                  & set(FORBIDDEN_MODULES))


def device_record(torch, chips: int, peak_bytes: int) -> Dict:
    return dict(platform='gpu', kind=torch.cuda.get_device_name(0),
                count=chips, memory_peak_bytes=int(peak_bytes))


def emit(result: Dict, checks: Dict[str, Dict[str, float]]) -> None:
    """The checks as the last lines on stderr, then the result line, the
    checks its last key, as the last line on stdout."""
    for name, c in checks.items():
        print(f'check {name} {c["value"]!r} limit {c["limit"]!r}',
              file=sys.stderr, flush=True)
    result = dict(result, checks=checks)
    print(json.dumps(result), flush=True)


def judge(values: Dict[str, float], limits: Dict[str, float]
          ) -> Dict[str, Dict[str, float]]:
    """Each compared number beside its limit; every limit must be named."""
    missing = set(limits) - set(values)
    if missing:
        raise KeyError(f'limits name numbers the run did not compare: '
                       f'{sorted(missing)}')
    return {n: dict(value=float(values[n]), limit=float(limits[n]))
            for n in limits}


def all_within(checks: Dict[str, Dict[str, float]]) -> bool:
    return bool(checks) and all(
        np.isfinite(c['value']) and c['value'] <= c['limit']
        for c in checks.values())
