"""Data parallelism across processes: the mesh's data axis and the
multi-process helpers.

Counterpart of fitv2_tpu/parallel/mesh.py. JAX lays one mesh over every
chip and names its axes (data, stage, fsdp, sequence, tensor); the port
runs one process a card (``torchrun``), each holding the whole model, and
the mesh is its data axis only: gradients are averaged across the
processes (train/train_step.make_step), each process loads its share of
every global batch and samples its share of the FID images. The axes that
shard the model (stage, fsdp, sequence, tensor) are slice 9b and raise.

``init_distributed`` reads torchrun's environment (RANK, WORLD_SIZE,
LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT) and starts the
process group: NCCL where each process has a card of its own, gloo on the
CPU and where processes share a card (NCCL refuses two ranks on one
device). Without that environment, or with one process, nothing starts
and every helper here acts on the one process.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.overrides import TorchFunctionMode

AXES = ('data', 'stage', 'fsdp', 'sequence', 'tensor')


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Axis sizes; -1 means 'remaining devices'. Order: (data, stage,
    fsdp, sequence, tensor), as JAX's."""
    data: int = -1
    stage: int = 1
    fsdp: int = 1
    sequence: int = 1
    tensor: int = 1

    def resolve(self, n_devices: int) -> Tuple[int, int, int, int, int]:
        sizes = [self.data, self.stage, self.fsdp, self.sequence, self.tensor]
        free = [i for i, s in enumerate(sizes) if s == -1]
        fixed = int(np.prod([s for s in sizes if s != -1]))
        assert len(free) <= 1, 'at most one axis may be -1'
        if free:
            assert n_devices % fixed == 0, (n_devices, sizes)
            sizes[free[0]] = n_devices // fixed
        assert int(np.prod(sizes)) == n_devices, (
            f'mesh {sizes} != {n_devices} devices')
        return tuple(sizes)


def build_mesh(config: Optional[MeshConfig] = None,
               n_devices: Optional[int] = None) -> Dict[str, int]:
    """The axis sizes (JAX's ``Mesh.shape``) of ``config`` over
    ``n_devices`` (default: the processes). Only the data axis is ported:
    an extent other than 1 on another axis raises NotImplementedError."""
    config = config or MeshConfig()
    sharded = {a: getattr(config, a) for a in AXES[1:]
               if getattr(config, a) != 1}
    if sharded:
        raise NotImplementedError(
            f'mesh axes {sharded}: model sharding (stage, fsdp, sequence, '
            'tensor) is slice 9b, not ported; the port keeps the whole '
            'model on one device a process and parallelises over data')
    return dict(zip(AXES, config.resolve(
        process_count() if n_devices is None else n_devices)))


def init_distributed(device: str = 'cuda') -> Tuple[int, int]:
    """Start the process group torchrun's environment describes, once;
    returns (rank, world size). On a card, each process takes card
    LOCAL_RANK modulo the cards (``torch.cuda.set_device``)."""
    world = int(os.environ.get('WORLD_SIZE', '1'))
    if world <= 1 or dist.is_initialized():
        return process_index(), process_count()
    rank = int(os.environ['RANK'])
    local_rank = int(os.environ.get('LOCAL_RANK', rank))
    local_world = int(os.environ.get('LOCAL_WORLD_SIZE', world))
    backend = 'gloo'
    if torch.device(device).type == 'cuda':
        cards = torch.cuda.device_count()
        torch.cuda.set_device(local_rank % cards)
        if cards >= local_world:
            backend = 'nccl'
    dist.init_process_group(backend, rank=rank, world_size=world)
    return rank, world


def _active() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if _active() else 0


def process_count() -> int:
    return dist.get_world_size() if _active() else 1


def is_main_process() -> bool:
    return process_index() == 0


def print0(*args, **kwargs) -> None:
    if is_main_process():
        print(*args, **kwargs)


def sync_global_devices(name: str = 'barrier') -> None:
    """A barrier across the processes (``name`` is JAX's label)."""
    if process_count() > 1:
        dist.barrier()


def collective_device() -> torch.device:
    """Where the backend's collectives take their tensors: the card for
    NCCL, the host for gloo."""
    if _active() and dist.get_backend() == 'nccl':
        return torch.device('cuda', torch.cuda.current_device())
    return torch.device('cpu')


def all_reduce_mean_(tensor: torch.Tensor) -> torch.Tensor:
    """In place, the mean of ``tensor`` over the processes (a sum, then a
    division by their count); the tensor stays where it is."""
    world = process_count()
    if world == 1:
        return tensor
    dev = collective_device()
    buf = tensor if tensor.device == dev else tensor.to(dev)
    dist.all_reduce(buf)
    buf.div_(world)
    if buf is not tensor:
        tensor.copy_(buf)
    return tensor


def broadcast_(tensors: List[torch.Tensor], src: int = 0) -> None:
    """In place, process ``src``'s values of ``tensors`` on every process,
    through one flat broadcast."""
    if process_count() == 1:
        return
    flat = torch.cat([t.detach().reshape(-1) for t in tensors]).to(
        collective_device())
    dist.broadcast(flat, src)
    with torch.no_grad():
        for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
            t.copy_(part.view_as(t))


def process_allgather(x: Any, tiled: bool = False):
    """Every process's ``x`` (an array or tensor of one shape on all),
    stacked on a new leading process axis, or with ``tiled`` concatenated
    along axis 0; numpy in, numpy out."""
    is_np = not isinstance(x, torch.Tensor)
    t = torch.from_numpy(np.ascontiguousarray(x)) if is_np else x
    if process_count() == 1:
        parts = [t]
    else:
        dev = collective_device()
        src = t.to(dev)
        parts = [torch.empty_like(src) for _ in range(process_count())]
        dist.all_gather(parts, src)
        parts = [p.to(t.device) for p in parts]
    out = torch.cat(parts) if tiled else torch.stack(parts)
    return out.numpy() if is_np else out


class _RowShardDraws(TorchFunctionMode):
    """See ``row_shard_draws``."""

    _DRAWS = (torch.rand, torch.randn, torch.randint)

    def __init__(self, generator: torch.Generator, rank: int, world: int):
        super().__init__()
        self.generator, self.rank, self.world = generator, rank, world

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func not in self._DRAWS or kwargs.get('generator') is not \
                self.generator:
            return func(*args, **kwargs)
        if func is torch.randint:  # randint([low,] high, size)
            *lead, size = args
        elif len(args) == 1 and isinstance(args[0], (tuple, list)):
            lead, size = [], args[0]
        else:
            lead, size = [], args
        b = size[0]
        full = func(*lead, (b * self.world, *size[1:]), **kwargs)
        return full[self.rank * b:(self.rank + 1) * b]


def row_shard_draws(generator: Optional[torch.Generator]):
    """A context in which each ``torch.rand`` / ``randn`` / ``randint``
    from ``generator`` is drawn at the global batch (its leading size
    times the processes) and this process keeps its rows: with every
    process's generator seeded alike, a data-parallel step draws what one
    process draws for the whole batch, row for row. A no-op in one
    process or without a generator."""
    if generator is None or process_count() == 1:
        return contextlib.nullcontext()
    return _RowShardDraws(generator, process_index(), process_count())
