"""Scalar training statistics: moment accumulation and a collector.

Counterpart of fitv2_tpu/utils/training_stats.py (the StyleGAN stats
collector): values reduce to (num, sum, sum of squares) float32 triples;
``report`` accumulates them on the host by name, ``Collector`` turns them
into mean and standard deviation. Across processes ``psum_moments`` and
``Collector.update(cross_process=True)`` sum the triples with an
all-reduce (JAX's ``psum`` and ``process_allgather`` + sum).
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from fitv2_tpu_torch.parallel.mesh import (
    collective_device, process_count, process_index)

Tensor = torch.Tensor


def _all_reduce_sum(m: Tensor, group=None) -> Tensor:
    """The sum of ``m`` over the processes of ``group``, on m's device."""
    if process_count() == 1:
        return m
    buf = m.to(collective_device())
    dist.all_reduce(buf, group=group)
    return buf.to(m.device)


def moments(x) -> Tensor:
    """(num, sum, sum_sq) of all elements, a (3,) float32 tensor on x's
    device."""
    x = torch.as_tensor(x).to(torch.float32).reshape(-1)
    return torch.stack([torch.tensor(float(x.numel()), device=x.device),
                        x.sum(), (x * x).sum()])


def psum_moments(x, group=None) -> Tensor:
    """The moments summed over the processes of ``group`` (all by
    default)."""
    return _all_reduce_sum(moments(x), group)


_counters: Dict[str, np.ndarray] = {}


def report(name: str, value) -> None:
    """Add the moments of ``value`` to the host counter ``name``."""
    m = moments(value).detach().cpu().numpy()
    _counters[name] = _counters.get(name, np.zeros(3, np.float32)) + m


def report0(name: str, value) -> None:
    """``report`` on process 0 only."""
    if process_index() == 0:
        report(name, value)


class Collector:
    """Snapshots of the reported counters whose names match ``regex``."""

    def __init__(self, regex: str = '.*', keep_previous: bool = True):
        self._regex = re.compile(regex)
        self._keep = keep_previous
        self._moments: Dict[str, np.ndarray] = {}
        self.update()

    def names(self):
        return [n for n in _counters if self._regex.fullmatch(n)]

    def update(self, cross_process: bool = False) -> None:
        """Take the current counters (a counter with no new values keeps
        its previous snapshot) and reset them; ``cross_process`` sums each
        over the processes (every process must hold the same names)."""
        for name in self.names():
            m = _counters.pop(name, np.zeros(3, np.float32))
            if cross_process:
                m = _all_reduce_sum(torch.from_numpy(m)).numpy()
            if m[0] > 0 or name not in self._moments:
                self._moments[name] = m

    def num(self, name: str) -> float:
        return float(self._moments.get(name, np.zeros(3))[0])

    def mean(self, name: str) -> float:
        m = self._moments.get(name)
        if m is None or m[0] == 0:
            return float('nan')
        return float(m[1] / m[0])

    def std(self, name: str) -> float:
        m = self._moments.get(name)
        if m is None or m[0] <= 1 or not np.isfinite(m[1]):
            return 0.0
        mean = m[1] / m[0]
        return float(np.sqrt(max(m[2] / m[0] - mean ** 2, 0)))

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        return {name: {'num': self.num(name), 'mean': self.mean(name),
                       'std': self.std(name)}
                for name in self._moments}
