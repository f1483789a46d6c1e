"""The mesh over the processes, and the multi-process helpers.

Counterpart of fitv2_tpu/parallel/mesh.py. JAX lays one mesh over every
chip and names its axes (data, stage, fsdp, sequence, tensor); the port
runs one process a card (``torchrun``) and lays a named
``torch.distributed.device_mesh.DeviceMesh`` over the processes in JAX's
order, data outermost and tensor innermost (``build_mesh``, which returns
a ``Mesh``: JAX's ``mesh.shape`` dict, the DeviceMesh and the sub-groups
of each axis). What each axis does:

  - data: each process loads its share of every global batch; gradients
    are averaged over the axis (train/train_step.make_step);
  - fsdp: the batch is split over it too (``batch_sharding``: data x
    fsdp shards), and FSDP2 shards every parameter over it
    (parallel/sharding.py);
  - sequence: the tokens are split over it (``sequence_sharding``,
    ``constrain_sequence``; Ulysses attention, parallel/sharding.py);
  - tensor: Megatron tensor parallelism of the blocks
    (parallel/sharding.py);
  - stage: GPipe over the block stack (parallel/pipeline.py).

Ranks of one tensor, sequence or stage group hold the same batch shard:
they load the same rows and draw the same t, noise and label drops.

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

from fitv2_tpu_torch.parallel import comms

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


class Mesh:
    """The (data, stage, fsdp, sequence, tensor) mesh over the processes.

    ``shape``: JAX's ``Mesh.shape`` dict. ``device_mesh``: the named
    DeviceMesh over the processes (None in one process). ``group(axis)``:
    this rank's process group along ``axis`` (None where the axis has
    extent 1); ``coordinate(axis)``: its index there. A model holds its
    mesh as JAX's holds one (``sequence_mesh``): copies share it."""

    def __init__(self, shape: Dict[str, int], device_mesh=None):
        self.shape = dict(shape)
        self.device_mesh = device_mesh

    def __deepcopy__(self, memo):
        return self

    def __repr__(self) -> str:
        return f'Mesh({self.shape})'

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def group(self, axis: str):
        if self.size(axis) == 1 or self.device_mesh is None:
            return None
        return self.device_mesh.get_group(axis)

    def coordinate(self, axis: str) -> int:
        if self.size(axis) == 1 or self.device_mesh is None:
            return 0
        return self.device_mesh.get_local_rank(axis)

    @property
    def shards_model(self) -> bool:
        """Whether an axis other than data has extent above 1."""
        return any(self.size(a) > 1 for a in AXES[1:])


def build_mesh(config: Optional[MeshConfig] = None,
               n_devices: Optional[int] = None,
               device_type: Optional[str] = None) -> Mesh:
    """The mesh of ``config`` over ``n_devices`` (default: the processes).
    Where an axis other than data shards the model over more than one
    process, it lays a DeviceMesh of ``device_type`` over them (by
    default the process group's: 'cuda' under NCCL, else 'cpu'), data
    outermost: rank ``(((d * stage + s) * fsdp + f) * sequence + q) *
    tensor + t`` (data parallelism alone needs no process groups beyond
    the world's)."""
    config = config or MeshConfig()
    device_type = device_type or collective_device().type
    world = process_count()
    sizes = config.resolve(world if n_devices is None else n_devices)
    device_mesh = None
    if (world > 1 and int(np.prod(sizes)) == world
            and any(s > 1 for s in sizes[1:])):
        from torch.distributed.device_mesh import init_device_mesh
        device_mesh = init_device_mesh(device_type, sizes,
                                       mesh_dim_names=AXES)
    return Mesh(dict(zip(AXES, sizes)), device_mesh)


def batch_sharding(mesh: Optional[Mesh]) -> Tuple[int, int]:
    """(index, count) of this rank's batch shard: the batch is split over
    data x fsdp (JAX's ``P(('data', 'fsdp'))``); the ranks of a stage,
    sequence or tensor group share one shard. Without a mesh: the
    process's index and count."""
    if mesh is None:
        return process_index(), process_count()
    f = mesh.size('fsdp')
    return (mesh.coordinate('data') * f + mesh.coordinate('fsdp'),
            mesh.size('data') * f)


@dataclasses.dataclass(frozen=True)
class SequenceShard:
    """This rank's part of a token-split trunk: ``size`` contiguous token
    blocks over ``group``, this rank's the ``rank``-th."""
    group: Any
    size: int
    rank: int

    def split(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        return comms.split_dim(x, self.group, dim)

    def split_const(self, x: Optional[torch.Tensor], dim: int = 1):
        """This rank's block of a tensor that needs no gradient."""
        if x is None:
            return None
        n = x.shape[dim] // self.size
        return x.narrow(dim, self.rank * n, n).contiguous()

    def gather(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        return comms.gather_dim(x, self.group, dim)

    def to_heads(self, x: torch.Tensor) -> torch.Tensor:
        """(B, N/S, H, Dh) -> (B, N, H/S, Dh): Ulysses' first exchange."""
        return comms.all_to_all_4d(x, self.group, 2, 1)

    def to_tokens(self, x: torch.Tensor) -> torch.Tensor:
        """(B, N, H/S, Dh) -> (B, N/S, H, Dh): the exchange back."""
        return comms.all_to_all_4d(x, self.group, 1, 2)


def sequence_sharding(mesh: Optional[Mesh], n_tokens: int,
                      n_heads: Optional[int] = None
                      ) -> Optional[SequenceShard]:
    """The token split of an N-token trunk with ``n_heads`` heads a rank
    under ``mesh``'s sequence axis, or None where the trunk runs unsplit:
    no mesh or no sequence extent, a batch-only mesh (JAX pins its
    activations to a device layout that has no torch counterpart), or N
    or the heads not divisible by the extent (JAX then leaves the
    activations unconstrained, mesh.py:126-129)."""
    if mesh is None or mesh.size('sequence') == 1:
        return None
    s = mesh.size('sequence')
    if n_tokens % s or (n_heads or s) % s or mesh.group('sequence') is None:
        return None
    return SequenceShard(mesh.group('sequence'), s,
                         mesh.coordinate('sequence'))


def constrain_sequence(x: torch.Tensor, mesh: Optional[Mesh],
                       n_heads: Optional[int] = None) -> torch.Tensor:
    """JAX's activation constraint, eagerly: (B, N, ...) ``x`` cut to
    this rank's token block where ``sequence_sharding`` splits the trunk
    (``n_heads``: the heads a rank, if the split must divide them too),
    ``x`` itself everywhere else."""
    shard = sequence_sharding(mesh, x.shape[1], n_heads) \
        if x.dim() >= 2 else None
    return x if shard is None else shard.split(x)


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


def row_shard_draws(generator: Optional[torch.Generator],
                    mesh: Optional[Mesh] = None):
    """A context in which each ``torch.rand`` / ``randn`` / ``randint``
    from ``generator`` is drawn at the global batch (its leading size
    times the batch shards) and this rank keeps its shard's rows: with
    every rank's generator seeded alike, a parallel step draws what one
    process draws for the whole batch, row for row. The shards are the
    processes, or ``mesh``'s data x fsdp (``batch_sharding``). A no-op
    with one shard or without a generator."""
    index, count = batch_sharding(mesh)
    if generator is None or count == 1:
        return contextlib.nullcontext()
    return _RowShardDraws(generator, index, count)
