"""A traced window and the reductions the per-layer metrics read.

``record`` runs a callable under ``torch.profiler`` (host ops and device
activity) inside a ``bench.window`` range that ends after a device
synchronisation, and keeps the raw events as arrays: each device interval
(kernel or copy) with the host thread and time of its launch where the
runtime call that launched it was recorded, and each host range. Device
busy time is the union of the device intervals, so work that overlaps
(two streams) counts once; the idle share is 1 - busy / window.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

WINDOW = 'bench.window'


def union(spans: Iterable[Tuple[float, float]]) -> List[List[float]]:
    """The sorted, merged intervals of ``spans``."""
    merged: List[List[float]] = []
    for start, stop in sorted(spans):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], stop)
        else:
            merged.append([start, stop])
    return merged


def covered(spans: Iterable[Tuple[float, float]]) -> float:
    return sum(b - a for a, b in union(spans))


class Trace:
    """Device intervals and host ranges of one traced window, in ns."""

    def __init__(self, dev: List[Tuple], host: List[Tuple]):
        # dev: (name, start, end, is_copy, launch_thread, launch_ns)
        # host: (name, start, end, thread)
        self.dev_name = [d[0] for d in dev]
        self.dev = np.array([d[1:] for d in dev], np.float64).reshape(-1, 5)
        self.host_name = [h[0] for h in host]
        self.host = np.array([h[1:] for h in host], np.float64).reshape(-1, 3)
        win = [i for i, n in enumerate(self.host_name) if n == WINDOW]
        if not win:
            raise RuntimeError('the trace has no bench.window range')
        self.window = tuple(self.host[win[0], :2])
        self.main_thread = self.host[win[0], 2]

    # -- selections -------------------------------------------------------
    def kernels(self) -> np.ndarray:
        """Indices of the kernels (copies and memsets left out)."""
        return np.flatnonzero(self.dev[:, 2] == 0)

    def named(self, include: str, exclude: Sequence[str] = ()) -> np.ndarray:
        return np.array([i for i in self.kernels()
                         if include in self.dev_name[i]
                         and not any(x in self.dev_name[i] for x in exclude)],
                        np.int64)

    def launched_within(self, ranges: Sequence[Tuple[float, float]]
                        ) -> np.ndarray:
        """Device intervals launched from the window's thread at a time
        inside one of ``ranges``."""
        launch = self.dev[:, 4]
        sel = np.zeros(len(self.dev), bool)
        for a, b in ranges:
            sel |= (launch >= a) & (launch <= b)
        sel &= self.dev[:, 3] == self.main_thread
        return np.flatnonzero(sel)

    def ranges(self, name: str) -> List[Tuple[float, float]]:
        """The host ranges called ``name``."""
        return [(self.host[i, 0], self.host[i, 1])
                for i, n in enumerate(self.host_name) if n == name]

    # -- reductions -------------------------------------------------------
    def busy_ns(self, idx: Optional[np.ndarray] = None) -> float:
        rows = self.dev if idx is None else self.dev[idx]
        return covered((float(a), float(b)) for a, b in rows[:, :2])

    def sum_ns(self, idx: np.ndarray) -> float:
        rows = self.dev[idx]
        return float((rows[:, 1] - rows[:, 0]).sum())

    def window_ns(self) -> float:
        return float(self.window[1] - self.window[0])

    def breakdown(self, top: int = 10) -> Dict[str, List]:
        """The device operations that took most time, and the longest idle
        gaps, each by the innermost host range open when it began."""
        totals: Dict[str, float] = {}
        for i in range(len(self.dev)):
            name = self.dev_name[i][:96]
            totals[name] = totals.get(name, 0.0) + (
                self.dev[i, 1] - self.dev[i, 0]) / 1e9
        ops = sorted(totals.items(), key=lambda kv: -kv[1])[:top]
        busy = union((float(a), float(b)) for a, b in self.dev[:, :2])
        w0, w1 = self.window
        edges = [w0] + [x for a, b in busy for x in (a, b)] + [w1]
        gaps = [(max(edges[i], w0), min(edges[i + 1], w1))
                for i in range(0, len(edges) - 1, 2)]
        gaps = sorted((g for g in gaps if g[1] > g[0]),
                      key=lambda g: g[0] - g[1])[:top]
        named = [[self._host_at(a), (b - a) / 1e9] for a, b in gaps]
        return dict(device_ops=[[n, s] for n, s in ops], idle_gaps=named)

    def _host_at(self, t: float) -> str:
        s, e = self.host[:, 0], self.host[:, 1]
        bench = np.array([n.startswith('bench.') for n in self.host_name],
                         bool)
        for allow_bench in (False, True):
            open_ = (s <= t) & (e >= t) & (bench if allow_bench else ~bench)
            if open_.any():
                idx = np.flatnonzero(open_)
                return self.host_name[idx[np.argmax(s[idx])]]
        return 'host'


def from_kineto(events, device_type_cuda) -> Trace:
    """A Trace from ``prof.profiler.kineto_results.events()``."""
    launches: Dict[int, Tuple[float, float]] = {}
    dev, host = [], []
    for e in events:
        name = e.name()
        start = float(e.start_ns())
        end = start + float(e.duration_ns())
        if e.device_type() == device_type_cuda:
            dev.append((name, start, end, int(
                'Memcpy' in name or 'Memset' in name), e.correlation_id()))
        else:
            thread = float(e.start_thread_id())
            if name.startswith('cu'):
                launches[e.correlation_id()] = (thread, start)
            host.append((name, start, end, thread))
    # a host range (record_function) is mirrored on the
    # device's timeline over the work it launched: not device work itself
    annotations = {h[0] for h in host}
    dev_rows = []
    for name, start, end, copy, corr in dev:
        if name in annotations:
            continue
        thread, t = launches.get(corr, (-1.0, -1.0))
        dev_rows.append((name, start, end, copy, thread, t))
    return Trace(dev_rows, host)


def record(torch, fn: Callable[[], None]) -> Trace:
    """``fn`` under the profiler, inside the window range."""
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            fn()
            torch.cuda.synchronize()
    trace = from_kineto(prof.profiler.kineto_results.events(),
                        torch.autograd.DeviceType.CUDA)
    if not len(trace.kernels()):
        raise RuntimeError('torch.profiler recorded no kernel on the card')
    return trace
