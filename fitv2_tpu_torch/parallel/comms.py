"""The collectives that model sharding issues, and their autograd.

Every collective of parallel/ goes through here. Under NCCL (a card a
process) each takes the tensor where it lies. Under gloo, which the ranks
use on the CPU and when they share one card, gloo takes CUDA tensors for
the all-reduce, the all-gathers, the reduce-scatter and the all-to-all
(probed on the H100 with torch 2.11): those run in place too. Its send
and recv fail on a CUDA pointer, so they, and the broadcast, go through
host memory here (``collective_path`` names the path of each).

The autograd Functions are the Megatron and Ulysses operators:
``copy_to_group`` (identity forward, all-reduce backward) in front of a
column-parallel layer; ``reduce_from_group`` (all-reduce forward, identity
backward) behind a row-parallel one; ``gather_last_dim`` (all-gather
forward, own slice backward); ``split_dim`` / ``gather_dim`` (own slice /
all-gather forward, the converse backward) around the token-split trunk;
``all_to_all_4d`` (the Ulysses head/token exchange, its reverse
backward); ``keep_grad`` (identity forward, the gradient on one rank).

``CollectiveLog`` (``with CollectiveLog() as log:``) logs every c10d
collective issued inside it, FSDP2's own all-gathers and reduce-scatters
too: a dispatch mode, which the autograd threads inherit.
"""

from __future__ import annotations

import collections
from typing import List, Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

Tensor = torch.Tensor

# gloo's collectives that fail on CUDA tensors: through the host
_GLOO_HOST = frozenset({'send', 'recv', 'broadcast'})


def collective_path(op: str) -> str:
    """'device' or 'host': where ``op``'s tensors go under the current
    backend (NCCL: always the device)."""
    if dist.is_initialized() and dist.get_backend() == 'gloo' \
            and op in _GLOO_HOST:
        return 'host'
    return 'device'


def _host(t: Tensor, op: str) -> Tensor:
    return t.cpu() if collective_path(op) == 'host' else t


def all_reduce_(t: Tensor, group, op=dist.ReduceOp.SUM) -> Tensor:
    """In place, the sum (or ``op``) of ``t`` over ``group``."""
    dist.all_reduce(t, op=op, group=group)
    return t


def all_gather_cat(t: Tensor, group, dim: int) -> Tensor:
    """The group's ``t`` (one shape on every rank) concatenated along
    ``dim`` in group-rank order."""
    world = dist.get_world_size(group)
    src = t.movedim(dim, 0).contiguous()
    out = src.new_empty((world * src.shape[0],) + src.shape[1:])
    dist.all_gather_into_tensor(out, src, group=group)
    return out.movedim(0, dim).contiguous()


def send(t: Tensor, dst: int, group) -> None:
    """Blocking send of ``t`` to group rank ``dst``."""
    dist.send(_host(t.detach().contiguous(), 'send'),
              dist.get_global_rank(group, dst), group=group)


def recv(like: Tensor, src: int, group) -> Tensor:
    """A tensor shaped as ``like`` received from group rank ``src``, on
    ``like``'s device."""
    buf = _host(torch.empty_like(like), 'recv')
    dist.recv(buf, dist.get_global_rank(group, src), group=group)
    return buf.to(like.device)


def broadcast(t: Tensor, src: int, group) -> Tensor:
    """Group rank ``src``'s ``t`` on every rank of ``group`` (a new tensor
    on ``t``'s device)."""
    buf = _host(t.detach(), 'broadcast').clone().contiguous()
    dist.broadcast(buf, dist.get_global_rank(group, src), group=group)
    return buf.to(t.device)


# -- autograd operators -------------------------------------------------------

def _group_rank(group) -> int:
    return dist.get_rank(group)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return _sum_fp32(g, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum_fp32(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _sum_fp32(x: Tensor, group) -> Tensor:
    """The group's sum of ``x``, added in fp32 and returned in x's
    dtype."""
    buf = x.float().contiguous()
    if buf is x:
        buf = buf.clone()
    all_reduce_(buf, group)
    return buf.to(x.dtype)


def copy_to_group(x: Tensor, group) -> Tensor:
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: Tensor, group) -> Tensor:
    return _ReduceFromGroup.apply(x, group)


class _GatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        return all_gather_cat(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        r = _group_rank(ctx.group)
        return g.narrow(ctx.dim, r * ctx.n, ctx.n).contiguous(), None, None


class _SplitDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        world = dist.get_world_size(group)
        n = x.shape[dim] // world
        ctx.full, ctx.dim, ctx.start = x.shape, dim, _group_rank(group) * n
        return x.narrow(dim, ctx.start, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        out = g.new_zeros(ctx.full)
        out.narrow(ctx.dim, ctx.start, g.shape[ctx.dim]).copy_(g)
        return out, None, None


def gather_last_dim(x: Tensor, group) -> Tensor:
    """The group's ``x`` concatenated along the last dim; the backward
    keeps this rank's slice (every rank's upstream gradient is the
    same)."""
    return _GatherDim.apply(x, group, x.dim() - 1)


def gather_dim(x: Tensor, group, dim: int) -> Tensor:
    """The group's ``x`` concatenated along ``dim``; backward: own slice."""
    return _GatherDim.apply(x, group, dim)


def split_dim(x: Tensor, group, dim: int) -> Tensor:
    """This rank's contiguous 1/world of ``x`` along ``dim``; the backward
    puts its gradient back in place, zeros elsewhere."""
    return _SplitDim.apply(x, group, dim)


def _a2a(x: Tensor, group, scatter: int, gather: int) -> Tensor:
    """x split into world parts along ``scatter``, part j to rank j; the
    parts received concatenated along ``gather`` in rank order."""
    world = dist.get_world_size(group)
    src = x.unflatten(scatter, (world, x.shape[scatter] // world))
    src = src.movedim(scatter, 0).contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    # out[j] is rank j's part: block j of the gather axis
    return out.movedim(0, gather).flatten(gather, gather + 1)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, scatter, gather):
        ctx.group, ctx.scatter, ctx.gather = group, scatter, gather
        return _a2a(x, group, scatter, gather)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g, ctx.group, ctx.gather, ctx.scatter), None, None, None


def all_to_all_4d(x: Tensor, group, scatter: int, gather: int) -> Tensor:
    """Ulysses' exchange of a (B, tokens, heads, Dh) tensor: split along
    ``scatter``, concatenate along ``gather`` (2, 1: local tokens of all
    heads -> all tokens of local heads; 1, 2 back)."""
    return _AllToAll.apply(x, group, scatter, gather)


class _KeepGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, keep):
        ctx.keep = keep
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.keep else torch.zeros_like(g)), None


def keep_grad(x: Tensor, keep: bool) -> Tensor:
    """Identity forward; the backward passes the gradient where ``keep``
    and zeros elsewhere (a value computed alike on every rank of a group
    whose gradients are then summed counts once)."""
    return _KeepGrad.apply(x, keep)


# -- the collective log -------------------------------------------------------

_NAMES = {'allreduce_': 'all_reduce', 'allgather_': 'all_gather',
          '_allgather_base_': 'all_gather', 'allgather_into_tensor_coalesced_':
          'all_gather', 'reduce_scatter_': 'reduce_scatter',
          '_reduce_scatter_base_': 'reduce_scatter',
          'reduce_scatter_tensor_coalesced_': 'reduce_scatter',
          'alltoall_base_': 'all_to_all', 'alltoall_': 'all_to_all',
          'send': 'send', 'recv_': 'recv', 'recv_any_source_': 'recv',
          'broadcast_': 'broadcast', 'barrier': 'barrier'}


class CollectiveLog(TorchDispatchMode):
    """A dispatch mode that logs each c10d collective as (kind, element
    count of its first tensor); ``counts()`` tallies the kinds."""

    def __init__(self):
        super().__init__()
        self.calls: List[tuple] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == 'c10d':
            name = func.overloadpacket.__name__
            kind = _NAMES.get(name, name)
            self.calls.append((kind, _numel(args)))
        return func(*args, **(kwargs or {}))

    def counts(self) -> collections.Counter:
        return collections.Counter(k for k, _ in self.calls)


def _numel(args) -> Optional[int]:
    for a in args:
        if isinstance(a, Tensor):
            return a.numel()
        if isinstance(a, (list, tuple)) and a and isinstance(a[0], Tensor):
            return a[0].numel()
    return None
