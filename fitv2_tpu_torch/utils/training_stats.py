"""Scalar training statistics: moment accumulation and a collector.

Counterpart of fitv2_tpu/utils/training_stats.py (the StyleGAN stats
collector): values reduce to (num, sum, sum of squares) float32 triples;
``report`` accumulates them on the host by name, ``Collector`` turns them
into mean and standard deviation. One process: the cross-process
reductions (``psum_moments``, ``Collector.update(cross_process=True)``)
raise at a world size above 1 (multi-device is ROADMAP item 26).
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

Tensor = torch.Tensor


def _world_size() -> int:
    dist = torch.distributed
    return (dist.get_world_size()
            if dist.is_available() and dist.is_initialized() else 1)


def _rank() -> int:
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


def _single_process(what: str) -> None:
    if _world_size() > 1:
        raise NotImplementedError(
            f'{what} across processes: multi-device is not ported '
            '(ROADMAP.md item 26)')


def moments(x) -> Tensor:
    """(num, sum, sum_sq) of all elements, a (3,) float32 tensor on x's
    device."""
    x = torch.as_tensor(x).to(torch.float32).reshape(-1)
    return torch.stack([torch.tensor(float(x.numel()), device=x.device),
                        x.sum(), (x * x).sum()])


def psum_moments(x, group=None) -> Tensor:
    """The moments summed over the processes of ``group``: one process's
    own."""
    _single_process('psum_moments')
    return moments(x)


_counters: Dict[str, np.ndarray] = {}


def report(name: str, value) -> None:
    """Add the moments of ``value`` to the host counter ``name``."""
    m = moments(value).detach().cpu().numpy()
    _counters[name] = _counters.get(name, np.zeros(3, np.float32)) + m


def report0(name: str, value) -> None:
    """``report`` on process 0 only."""
    if _rank() == 0:
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
        its previous snapshot) and reset them."""
        if cross_process:
            _single_process('Collector.update')
        for name in self.names():
            m = _counters.pop(name, np.zeros(3, np.float32))
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
