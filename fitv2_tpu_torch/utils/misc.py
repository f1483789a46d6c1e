"""Misc utilities: shape asserts, profiling hooks, parameter summaries,
NaN guards, the analytic FLOP count.

Counterpart of fitv2_tpu/utils/misc.py: ``profiled_function`` labels a
function in ``torch.profiler`` traces (``record_function``), ``trace_to``
records a ``torch.profiler.profile`` of its block into a directory (a
Chrome trace), and ``check_cross_process_consistency`` all-gathers a
value and compares every process's with the first's. ``count_params`` and
``print_module_summary`` take a module or a nested mapping of tensors.
"""

from __future__ import annotations

import contextlib
import functools
import os
from typing import Any, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from fitv2_tpu_torch.parallel.mesh import process_allgather, process_count


class EasyDict(dict):
    """A dict whose items are also attributes."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        self[name] = value

    def __delattr__(self, name):
        del self[name]


def assert_shape(tensor, ref_shape: Sequence[Optional[int]]) -> None:
    """Shape assertion; None in ``ref_shape`` matches any size."""
    if tensor.ndim != len(ref_shape):
        raise AssertionError(
            f'Wrong number of dimensions: got {tensor.ndim}, '
            f'expected {len(ref_shape)}')
    for idx, (size, ref) in enumerate(zip(tensor.shape, ref_shape)):
        if ref is not None and size != ref:
            raise AssertionError(
                f'Wrong size for dimension {idx}: got {size}, expected {ref}')


def profiled_function(fn):
    """Label each call of ``fn`` in ``torch.profiler`` traces."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with torch.profiler.record_function(fn.__name__):
            return fn(*args, **kwargs)
    return wrapper


@contextlib.contextmanager
def trace_to(log_dir: str):
    """Profile the block (CPU, and CUDA where a card is present) and write
    its Chrome trace into ``log_dir``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, 'trace.json'))


def nan_to_num(x, nan: float = 0.0, posinf: Optional[float] = None,
               neginf: Optional[float] = None):
    return torch.nan_to_num(torch.as_tensor(x), nan=nan, posinf=posinf,
                            neginf=neginf)


def check_cross_process_consistency(x, name: str = 'tensor') -> bool:
    """Whether every process holds the same ``x`` (bit for bit); a process
    that finds a difference prints ``name``."""
    if process_count() == 1:
        return True
    gathered = process_allgather(torch.as_tensor(x))
    ok = bool((gathered == gathered[0]).all())
    if not ok:
        print(f'[consistency] {name} differs across processes')
    return ok


def _named_leaves(params: Any, prefix: str = ''
                  ) -> Iterator[Tuple[str, Tuple[int, ...]]]:
    if isinstance(params, torch.nn.Module):
        for name, p in params.named_parameters():
            yield name, tuple(p.shape)
    elif isinstance(params, dict):
        for k, v in params.items():
            yield from _named_leaves(v, f'{prefix}/{k}' if prefix else str(k))
    else:
        yield prefix, tuple(params.shape)


def count_params(params) -> int:
    return sum(int(np.prod(shape)) for _, shape in _named_leaves(params))


def print_module_summary(params, max_rows: int = 40) -> str:
    """A table of the parameters, largest first, with the total; printed
    and returned."""
    rows = [(name, shape, int(np.prod(shape)))
            for name, shape in _named_leaves(params)]
    rows.sort(key=lambda r: -r[2])
    total = sum(r[2] for r in rows)
    lines = [f'{"name":<64} {"shape":<24} {"params":>12}']
    for name, shape, n in rows[:max_rows]:
        lines.append(f'{name[:64]:<64} {str(shape):<24} {n:>12,}')
    if len(rows) > max_rows:
        lines.append(f'... ({len(rows) - max_rows} more)')
    lines.append(f'{"TOTAL":<64} {"":<24} {total:>12,}')
    out = '\n'.join(lines)
    print(out)
    return out


def flop_count_forward(hidden: int, depth: int, n_tokens: int,
                       mlp_hidden: Optional[int] = None,
                       heads: Optional[int] = None) -> float:
    """Analytic FLOPs (2 per multiply-add) of one FiT forward per sample:
    qkv, attention scores and values, the output projection, the SwiGLU's
    three matrices (hidden 8d/3 by default)."""
    d = hidden
    m = mlp_hidden if mlp_hidden is not None else (4 * d * 2) // 3
    n = n_tokens
    per_block = (2 * n * d * 3 * d + 2 * n * n * d * 2 + 2 * n * d * d
                 + 2 * n * d * m * 3)
    return depth * per_block
