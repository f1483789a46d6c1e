"""Model sharding over the mesh: tensor parallelism, FSDP2, and the
layout that the train step and the checkpoints read.

Counterpart of ``_spec_for_param`` / ``fit_param_shardings`` /
``shard_params`` of fitv2_tpu/parallel/mesh.py. JAX gives every parameter
leaf a ``PartitionSpec`` and XLA inserts the collectives; the port places
the parameters and issues the collectives itself:

- tensor (``tensor_parallel_``): Megatron's split of every FiT block —
  column-parallel qkv, fc1 and the adaLN output layer, row-parallel proj
  and fc2 — as modules that hold this rank's slice of the weight
  (``ColumnParallelLinear``, ``RowParallelLinear``, comms.py's operators
  around them). JAX splits the fused kernels contiguously and lets XLA lay
  them out again; here each rank holds the q, k and v rows of its own
  H/T heads, and the gate and value rows of its own 1/T of SwiGLU's
  hidden units, because the block splits one fused output into them
  (``qkv.view(B, N, 3, H, Dh)``, ``fc1(x).chunk(2)``). That per-rank
  layout is no DTensor placement of the model's layout, so the slices
  are plain tensors and the layout lives in ``ShardedLayout``; a
  checkpoint is written in the one-process layout. The adaLN output layer
  is column-parallel with its output gathered (the block chunks it into
  six whole-width terms); the global adaLN, the embedders and the final
  layer stay whole on every rank, as JAX's rule leaves the non-adaLN ones
  (it also splits those adaLN kernels: XLA gathers them again).
- fsdp (``fully_shard_``): FSDP2's ``fully_shard`` on every block, then
  on the root, over the fsdp sub-mesh, with ``MixedPrecisionPolicy(
  param_dtype=compute dtype, reduce_dtype=fp32)`` over fp32 shards: one
  all-gather a block in forward and one in backward, one reduce-scatter
  a block (averaging over fsdp). JAX shards the largest divisible
  dimension of each leaf; FSDP2 shards dim 0 of each parameter, unevenly
  where it does not divide. Without fsdp the trainers keep their fp32
  masters and a compute-dtype copy.
- data and sequence: ``ShardedLayout.reduce_grads`` averages the local
  gradients over data and sums them over sequence (each sequence rank's
  gradient covers its tokens); stage: it sums the whole-model parameters'
  gradients over the pipeline (parallel/pipeline.py); tensor: it sums the
  gradients of the q/k norms' weights, which every rank holds whole but
  applies to its own heads only.

``ShardedLayout`` also gives the global gradient norm over every shard
(of the whole model, or of one group of a ``MultiTransform``) and
converts a train state to and from the one-process layout (process 0
writes it; every rank restores its shards from it): the masters, the EMA,
and AdamW's, CAME's or a ``MultiTransform``'s state (train/came.py keeps
CAME's factored statistics whole on every rank).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from fitv2_tpu_torch.parallel import comms
from fitv2_tpu_torch.parallel.mesh import AXES, Mesh

Tensor = torch.Tensor


class _GroupRef:
    """A process group held by a module: copies of the module share it."""

    def __init__(self, group):
        self.group = group

    def __deepcopy__(self, memo):
        return self


class ColumnParallelLinear(nn.Module):
    """This rank's rows of a Linear: the input's gradient is summed over
    the tensor group (``copy_to_group``); with ``gather`` the output is
    the group's outputs concatenated (the rows lie in rank order)."""

    def __init__(self, weight: Tensor, bias: Optional[Tensor], group,
                 gather: bool = False):
        super().__init__()
        self.weight = nn.Parameter(weight)
        self.bias = None if bias is None else nn.Parameter(bias)
        self._group = _GroupRef(group)
        self.gather = gather

    def forward(self, x: Tensor) -> Tensor:
        y = F.linear(comms.copy_to_group(x, self._group.group), self.weight,
                     self.bias)
        return comms.gather_last_dim(y, self._group.group) if self.gather \
            else y


class RowParallelLinear(nn.Module):
    """This rank's input columns of a Linear: the partial products are
    summed over the tensor group (in fp32), then the whole bias added."""

    def __init__(self, weight: Tensor, bias: Optional[Tensor], group):
        super().__init__()
        self.weight = nn.Parameter(weight)
        self.bias = None if bias is None else nn.Parameter(bias)
        self._group = _GroupRef(group)

    def forward(self, x: Tensor) -> Tensor:
        y = comms.reduce_from_group(F.linear(x, self.weight),
                                    self._group.group)
        return y if self.bias is None else y + self.bias


def _rows(size: int, parts: int, world: int, rank: int) -> Tensor:
    """Rank ``rank``'s rows of a dim of ``size`` made of ``parts`` equal
    parts (q, k, v; gate, value), each split contiguously over
    ``world``."""
    part = size // parts
    if part % world:
        raise ValueError(f'{part} rows do not split over {world} ranks')
    n = part // world
    return torch.cat([torch.arange(p * part + rank * n, p * part + (rank + 1)
                                   * n) for p in range(parts)])


@dataclasses.dataclass
class TPSplit:
    """Where a parameter is split over the tensor group: along ``dim``,
    rank r holding the indices ``index[r]`` of the one-process tensor."""
    dim: int
    index: List[Tensor]


def _blocks(model: nn.Module) -> List[Tuple[str, nn.Module]]:
    from fitv2_tpu_torch.models.modules import FiTBlock
    return [(n, m) for n, m in model.named_modules()
            if isinstance(m, FiTBlock)]


def _tp_layers(block: nn.Module) -> List[Tuple[nn.Module, str, str, int]]:
    """The Linears of a FiT block that the tensor axis splits: (parent,
    attribute, 'column' or 'row', the equal parts of a column layer's
    output rows). The adaLN output layer's output is gathered."""
    attn, mlp, ada = block.attn, block.mlp, block.adaLN_modulation
    swiglu = type(mlp).__name__ == 'SwiGLU'
    return [(attn, 'qkv', 'column', 3), (attn, 'proj', 'row', 1),
            (mlp, 'fc1', 'column', 2 if swiglu else 1),
            (mlp, 'fc2', 'row', 1),
            (ada, 'fc2' if ada.adaln_type == 'swiglu' else 'fc_out',
             'column', 1)]


def _tp_partial(model: nn.Module) -> List[str]:
    """The parameters that stay whole on every tensor rank but act inside
    the head split: the q/k norms' weights, shared by every head, whose
    gradient on a rank covers its own heads only."""
    return [f'{name}.attn.{norm}.weight' for name, block in _blocks(model)
            for norm in ('q_norm', 'k_norm')
            if hasattr(getattr(block.attn, norm), 'weight')]


def tensor_parallel_(model: nn.Module, mesh: Mesh) -> Dict[str, TPSplit]:
    """Split every FiT block of ``model`` over ``mesh``'s tensor axis, in
    place; returns each split parameter's ``TPSplit`` by name."""
    world = mesh.size('tensor')
    if world == 1:
        return {}
    group, rank = mesh.group('tensor'), mesh.coordinate('tensor')
    splits: Dict[str, TPSplit] = {}

    def column(parent, attr, prefix, parts, gather=False):
        lin = getattr(parent, attr)
        index = [_rows(lin.out_features, parts, world, r)
                 for r in range(world)]
        w = lin.weight.detach()[index[rank]].clone()
        b = None if lin.bias is None else \
            lin.bias.detach()[index[rank]].clone()
        setattr(parent, attr, ColumnParallelLinear(w, b, group, gather))
        splits[f'{prefix}.weight'] = TPSplit(0, index)
        if b is not None:
            splits[f'{prefix}.bias'] = TPSplit(0, index)

    def row(parent, attr, prefix):
        lin = getattr(parent, attr)
        index = [_rows(lin.in_features, 1, world, r) for r in range(world)]
        w = lin.weight.detach()[:, index[rank]].clone()
        b = None if lin.bias is None else lin.bias.detach().clone()
        setattr(parent, attr, RowParallelLinear(w, b, group))
        splits[f'{prefix}.weight'] = TPSplit(1, index)

    where = {m: n for n, m in model.named_modules()}
    for _, block in _blocks(model):
        attn = block.attn
        if attn.num_heads % world:
            raise ValueError(f'{attn.num_heads} heads do not split over '
                             f'{world} tensor ranks')
        if getattr(attn, 'quantized', False) or attn.fused:
            raise ValueError('tensor parallelism splits the bf16 training '
                             'blocks only (no int8, no fused attention)')
        for parent, attr, kind, parts in _tp_layers(block):
            prefix = f'{where[parent]}.{attr}'
            if kind == 'row':
                row(parent, attr, prefix)
            else:
                column(parent, attr, prefix, parts,
                       gather=parent is block.adaLN_modulation)
        attn.tp_size = world
    return splits


def fully_shard_(model: nn.Module, mesh: Mesh,
                 param_dtype: Optional[torch.dtype],
                 forward_methods: Sequence[str] = ()) -> nn.Module:
    """FSDP2 over ``mesh``'s fsdp axis: ``fully_shard`` on every FiT block,
    then on the root, fp32 shards computing in ``param_dtype``.
    ``forward_methods``: the root's methods other than ``forward`` that
    run a training forward (FSDP2 hooks them too)."""
    from torch.distributed.fsdp import (
        MixedPrecisionPolicy, fully_shard, register_fsdp_forward_method)
    sub = mesh.device_mesh['fsdp']
    policy = MixedPrecisionPolicy(param_dtype=param_dtype,
                                  reduce_dtype=torch.float32,
                                  cast_forward_inputs=False)
    for _, block in _blocks(model):
        fully_shard(block, mesh=sub, mp_policy=policy)
    fully_shard(model, mesh=sub, mp_policy=policy)
    for method in forward_methods:
        if hasattr(model, method):
            register_fsdp_forward_method(model, method)
    return model


def local(t: Optional[Tensor]) -> Optional[Tensor]:
    """The local tensor of a DTensor (FSDP2's shard: the same tensor at
    every call, which the optimizer updates in place), or ``t``."""
    from torch.distributed.tensor import DTensor
    return t._local_tensor if isinstance(t, DTensor) else t


def is_sharded(model: nn.Module) -> bool:
    """Whether ``shard_model`` placed ``model`` over a mesh: a pipeline's
    stage, a sequence mesh, tensor-parallel layers or FSDP2's DTensors."""
    from torch.distributed.tensor import DTensor
    return (getattr(model, 'pipeline', None) is not None
            or getattr(model, 'sequence_mesh', None) is not None
            or any(isinstance(m, (ColumnParallelLinear, RowParallelLinear))
                   for m in model.modules())
            or any(isinstance(p, DTensor) for p in model.parameters()))


class ShardedLayout:
    """How a model's parameters lie over ``mesh``, and the train step's
    reductions and the checkpoint's conversions that follow from it.

    ``names``: the one-process parameter names in order, with their
    ``shapes``; ``tp``: the tensor splits; ``tp_partial``: the parameters
    whole on every tensor rank whose gradient a rank holds only in part
    (``_tp_partial``); ``stage_owner``: the stage
    that holds a block parameter under the pipeline (None: every stage);
    ``fsdp``: whether FSDP2 shards the parameters; ``model``: the module
    whose (local) parameters the masters are."""

    def __init__(self, mesh: Mesh, model: nn.Module, tp: Dict[str, TPSplit],
                 stage_owner: Dict[str, Optional[int]],
                 full_shapes: Dict[str, torch.Size],
                 tp_partial: Sequence[str] = ()):
        self.mesh = mesh
        self.model = model
        self.tp = tp
        self.tp_partial = frozenset(tp_partial)
        self.stage_owner = stage_owner
        self.names = list(full_shapes)
        self.shapes = full_shapes
        self.fsdp = mesh.size('fsdp') > 1
        self.params = {n: p for n, p in model.named_parameters()}

    # -- the step -------------------------------------------------------------

    def holds(self, name: str) -> bool:
        owner = self.stage_owner.get(name)
        return owner is None or owner == self.mesh.coordinate('stage')

    def reduce_grads(self, names: Sequence[str], grads: List[Tensor]
                     ) -> List[Tensor]:
        """The local fp32 gradients (FSDP2's already averaged over fsdp)
        averaged over data, summed over sequence, for parameters every
        stage holds summed over stage, and for ``tp_partial`` summed over
        tensor; in place."""
        mesh = self.mesh
        if mesh.size('tensor') > 1:
            flat_sum([g for n, g in zip(names, grads)
                       if n in self.tp_partial], mesh.group('tensor'))
        if mesh.size('data') > 1:
            flat_sum(grads, mesh.group('data'), 1.0 / mesh.size('data'))
        if mesh.size('sequence') > 1:
            flat_sum(grads, mesh.group('sequence'))
        if mesh.size('stage') > 1:
            whole = [g for n, g in zip(names, grads)
                     if self.stage_owner.get(n) is None]
            flat_sum(whole, mesh.group('stage'))
        return grads

    def axes(self, name: str) -> Tuple[str, ...]:
        """The mesh axes over which the ranks' parts of parameter
        ``name`` tile it (a stage holds all or nothing of a block's)."""
        axes = []
        if self.fsdp:
            axes.append('fsdp')
        if name in self.tp:
            axes.append('tensor')
        if self.stage_owner.get(name) is not None:
            axes.append('stage')
        return tuple(axes)

    def global_norm(self, names: Sequence[str], grads: List[Tensor]
                    ) -> Tensor:
        """The L2 norm of the whole gradient of the parameters ``names``
        (``grads``: this rank's of them, maybe none), on the masters'
        device: each parameter's local squares summed over the axes that
        split it, and once for the axes that replicate it. Every rank
        makes the same collectives, whichever of ``names`` it holds, and
        every rank that holds the same gradients gets the same bits (no
        atomic adds: the clip factor must not differ between replicas)."""
        device = self._device()
        split = [a for a in ('fsdp', 'tensor', 'stage')
                 if self.mesh.size(a) > 1]
        keys = [tuple(a for i, a in enumerate(split) if bits >> i & 1)
                for bits in range(2 ** len(split))]
        axes = [self.axes(n) for n in names]
        sq = (torch.stack(torch._foreach_norm([g.float() for g in grads]))
              ** 2 if grads else torch.zeros(0, device=device))
        pick = torch.tensor([[a == k for a in axes] for k in keys],
                            dtype=torch.bool, device=device).reshape(
                                len(keys), len(axes))
        sums = torch.where(pick, sq, torch.zeros_like(sq)).sum(dim=1)
        for axis in split:
            hit = torch.tensor([axis in k for k in keys], device=device)
            part = torch.where(hit, sums, torch.zeros_like(sums))
            comms.all_reduce_(part, self.mesh.group(axis))
            sums = torch.where(hit, part, sums)
        return sums.sum().sqrt()

    # -- the one-process layout -----------------------------------------------

    @torch.no_grad()
    def to_full(self, name: str, t: Optional[Tensor],
                dtype: torch.dtype = torch.float32) -> Tensor:
        """The one-process tensor of parameter ``name``'s local state
        ``t`` (its value, a moment or its EMA; ``dtype``: its dtype, which
        a stage that does not hold it passes): a collective over the
        ranks, whole on every rank."""
        mesh = self.mesh
        owner = self.stage_owner.get(name)
        mine = self.holds(name)
        if mine:
            full = t
            if self.fsdp:  # FSDP2's dim-0 chunks, padded to one size
                rows = self.params[name].shape[0]
                n = mesh.size('fsdp')
                size = -(-rows // n)
                pad = t.new_zeros((size,) + tuple(t.shape[1:]))
                pad[:t.shape[0]] = t
                full = comms.all_gather_cat(pad, mesh.group('fsdp'),
                                            0)[:rows]
            split = self.tp.get(name)
            if split is not None:
                parts = comms.all_gather_cat(full, mesh.group('tensor'),
                                             split.dim)
                out = parts.new_empty(self.shapes[name])
                out.index_copy_(split.dim, torch.cat(split.index).to(
                    parts.device), parts)
                full = out
        if owner is not None:
            if not mine:
                full = torch.empty(self.shapes[name], dtype=dtype,
                                   device=self._device())
            full = comms.broadcast(full, owner, mesh.group('stage'))
        return full

    @torch.no_grad()
    def from_full(self, name: str, full: Tensor) -> Optional[Tensor]:
        """This rank's part of parameter ``name``'s one-process tensor
        ``full`` (None where its stage does not hold it)."""
        if not self.holds(name):
            return None
        split = self.tp.get(name)
        if split is not None:
            full = full.index_select(
                split.dim, split.index[self.mesh.coordinate('tensor')])
        if self.fsdp:
            f, n = self.mesh.coordinate('fsdp'), self.mesh.size('fsdp')
            chunks = list(torch.chunk(full, n, dim=0))
            full = chunks[f] if f < len(chunks) else full[:0]
        return full

    def _device(self) -> torch.device:
        return next(p for p in self.params.values()
                    if p.device.type != 'meta').device

    @torch.no_grad()
    def full_state_dict(self, state) -> Optional[Dict[str, Any]]:
        """``state`` (a train state over the local parameters) in the
        one-process layout, whole on process 0 (on the host there, None
        elsewhere): a collective over every rank. The optimizer's state is
        the one-process optimizer's: AdamW's moments by parameter, CAME's
        by its leaves' first parameters in JAX's layout, a
        ``MultiTransform``'s by label."""
        main = dist.get_rank() == 0

        def full(name, t, dtype=torch.float32):
            out = self.to_full(name, t, dtype)
            return out.cpu() if main else None

        sd = dict(step=state.step,
                  params={n: full(n, state.params.get(n)) for n in self.names},
                  ema_params={n: full(n, state.ema_params.get(n))
                              for n in self.names},
                  optimizer=self._full_optimizer(state.optimizer, self.names,
                                                 state.params, full))
        acc = state.accumulator
        index = {n: i for i, n in enumerate(state.params)}
        sd['accumulator'] = None if acc is None else dict(
            mini_step=acc.mini_step, gradient_step=acc.gradient_step,
            acc=[full(n, acc.acc[index[n]] if n in index else None)
                 for n in self.names])
        return sd if main else None

    def _full_optimizer(self, opt, names: Sequence[str],
                        masters: Dict[str, Tensor], full) -> Dict[str, Any]:
        """The one-process state dict of ``opt``, the optimizer over the
        parameters ``names`` (in its one-process order)."""
        from fitv2_tpu_torch.train.came import CAME
        from fitv2_tpu_torch.train.train_step import MultiTransform
        if isinstance(opt, MultiTransform):
            return {label: self._full_optimizer(o, opt.members[label],
                                                masters, full)
                    for label, o in opt.optimizers.items() if o is not None}
        group = dict(opt.param_groups[0])
        group['params'] = list(range(len(names)))
        out: Dict[int, Dict[str, Any]] = {}
        main = dist.get_rank() == 0
        stepped = _agree(len(opt.state) > 0, self._device())
        if stepped and isinstance(opt, CAME):
            pos = {n: j for j, n in enumerate(names)}
            for leaf, part in zip(opt.leaves, opt.parts):
                st = opt.leaf_state(leaf)
                keys = (('m', 'r_row', 'r_col', 's_row', 's_col')
                        if len(part.shape) >= 2 else ('m', 'r_full'))
                entry = {}
                for k in keys:
                    if k in ('m', 'r_full'):  # sharded as the parameter
                        mine = {} if k not in st else dict(zip(
                            part.names, leaf.from_jax(st[k])))
                        whole = [full(n, None if n not in mine
                                      else mine[n].contiguous())
                                 for n in leaf.names]
                        entry[k] = leaf.to_jax(whole).clone() if main \
                            else None
                    else:  # whole on every rank
                        entry[k] = st[k].to('cpu', copy=True) if main \
                            else None
                out[pos[leaf.names[0]]] = entry
        elif stepped:
            for j, n in enumerate(names):
                p = masters.get(n)
                st = opt.state.get(p) if p is not None else None
                out[j] = {k: full(n, None if st is None else st[k],
                                  opt.mu_dtype if k == 'mu' and opt.mu_dtype
                                  else torch.float32) for k in ('mu', 'nu')}
        return dict(state=out, param_groups=[group])

    @torch.no_grad()
    def load_full_state_dict(self, state, sd: Dict[str, Any]) -> None:
        """Restore ``state``'s local tensors from a one-process state
        dict (every rank reads the same one)."""
        names = list(state.params)
        pos = {n: j for j, n in enumerate(self.names)}
        local_sd = dict(
            step=sd['step'],
            params={n: self.from_full(n, sd['params'][n]) for n in names},
            ema_params={n: self.from_full(n, sd['ema_params'][n])
                        for n in names},
            optimizer=self._local_optimizer(state.optimizer, self.names,
                                            sd['optimizer'], state.params))
        acc = sd['accumulator']
        local_sd['accumulator'] = None if acc is None else dict(
            acc, acc=[self.from_full(n, acc['acc'][pos[n]]) for n in names])
        state.load_state_dict(local_sd)

    def _local_optimizer(self, opt, names: Sequence[str],
                         saved: Dict[str, Any], masters: Dict[str, Tensor]
                         ) -> Dict[str, Any]:
        """This rank's state dict of ``opt`` (over ``names``) from its
        one-process state dict ``saved``."""
        from fitv2_tpu_torch.train.came import CAME
        from fitv2_tpu_torch.train.train_step import MultiTransform
        if isinstance(opt, MultiTransform):
            return {label: self._local_optimizer(o, opt.members[label],
                                                 saved[label], masters)
                    for label, o in opt.optimizers.items() if o is not None}
        pos = {n: j for j, n in enumerate(names)}
        group = dict(saved['param_groups'][0])
        group['params'] = list(range(len(opt.param_groups[0]['params'])))
        state: Dict[Any, Dict[str, Tensor]] = {}
        if isinstance(opt, CAME):
            device = self._device()
            for leaf, part in zip(opt.leaves, opt.parts):
                entry = saved['state'].get(pos[leaf.names[0]])
                if entry is None:
                    continue
                st = state[leaf.path] = {}
                for k, v in entry.items():
                    if k not in ('m', 'r_full'):
                        st[k] = v.to(device, torch.float32, copy=True)
                    elif part.names:
                        mine = [self.from_full(n, t) for n, t in
                                zip(leaf.names, leaf.from_jax(v))
                                if n in part.names]
                        st[k] = leaf.to_jax(mine).to(device, torch.float32,
                                                     copy=True)
        else:
            local = [n for n in names if n in masters]
            state = {i: {k: self.from_full(n, v) for k, v in
                         saved['state'][pos[n]].items()}
                     for i, n in enumerate(local)
                     if pos[n] in saved['state']}
        return dict(state=state, param_groups=[group])


def _agree(flag: bool, device: torch.device) -> bool:
    """``flag`` or'ed over every process (a collective on ``device``, where
    the backend takes its tensors)."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return flag
    t = torch.tensor([int(flag)], device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def flat_sum(tensors: List[Tensor], group, scale: float = 1.0) -> None:
    """In place, each tensor's sum over ``group`` times ``scale``,
    through one flat buffer."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    comms.all_reduce_(flat, group)
    if scale != 1.0:
        flat.mul_(scale)
    torch._foreach_copy_(tensors, [p.view_as(t) for p, t in zip(
        flat.split([t.numel() for t in tensors]), tensors)])


def shard_model(model: nn.Module, mesh: Mesh,
                compute_dtype: torch.dtype = torch.float32,
                forward_methods: Sequence[str] = (),
                pp_microbatches: int = 1
                ) -> Tuple[nn.Module, ShardedLayout]:
    """Place the fp32 ``model`` (on its device, the same weights on every
    rank) over ``mesh``: the pipeline's stages
    (``pipeline.make_pipelined_forward``, ``pp_microbatches``), the
    sequence mesh, the tensor split, then FSDP2 or, without fsdp, a
    ``compute_dtype`` copy. Returns (the module that computes, the layout
    over the masters' module). The masters are the parameters of
    ``layout.model``: the fp32 model's local tensors."""
    check_axes(mesh)
    full_shapes = {n: p.shape for n, p in model.named_parameters()}
    stage_owner: Dict[str, Optional[int]] = {}
    if mesh.size('stage') > 1:
        from fitv2_tpu_torch.parallel.pipeline import (
            make_pipelined_forward, pipeline_param_shardings)
        stage_owner = pipeline_param_shardings(mesh, model)
        make_pipelined_forward(model, mesh, pp_microbatches)
    if mesh.size('sequence') > 1:
        model.sequence_mesh = mesh
    tp = tensor_parallel_(model, mesh)
    partial = _tp_partial(model) if tp else []
    if mesh.size('fsdp') > 1:
        fully_shard_(model, mesh, None if compute_dtype == torch.float32
                     else compute_dtype, forward_methods)
        compute = model
    else:
        import copy
        compute = model if compute_dtype == torch.float32 else \
            copy.deepcopy(model).to(compute_dtype)
    return compute, ShardedLayout(mesh, model, tp, stage_owner, full_shapes,
                                  partial)


def fit_param_shardings(mesh: Mesh, model: nn.Module
                        ) -> Dict[str, Tuple[str, ...]]:
    """JAX's ``fit_param_shardings`` as a table: parameter name -> the mesh
    axes that split it here (fsdp: FSDP2's dim 0; tensor: the Megatron
    split of ``tensor_parallel_``; stage: the pipeline's blocks)."""
    tensor = mesh.size('tensor') > 1
    split = set()
    where = {m: n for n, m in model.named_modules()}
    for _, block in _blocks(model):
        for parent, attr, kind, _ in _tp_layers(block):
            prefix = f'{where[parent]}.{attr}'
            split.add(f'{prefix}.weight')
            if kind == 'column':
                split.add(f'{prefix}.bias')
    out = {}
    for name, _ in model.named_parameters():
        axes = []
        if mesh.size('stage') > 1 and name.startswith('blocks.'):
            axes.append('stage')
        if mesh.size('fsdp') > 1:
            axes.append('fsdp')
        if tensor and name in split:
            axes.append('tensor')
        out[name] = tuple(axes)
    return out


def replicated(mesh: Mesh) -> Tuple[str, ...]:
    """JAX's ``replicated``: a tensor that no axis splits (the entry of
    ``fit_param_shardings`` for a parameter every rank holds whole)."""
    return ()


def shard_params(mesh: Mesh, model: nn.Module,
                 compute_dtype: torch.dtype = torch.float32):
    """JAX's ``shard_params``: ``shard_model`` (the model placed over the
    mesh; returns the computing module and the layout)."""
    return shard_model(model, mesh, compute_dtype)


def check_axes(mesh: Mesh) -> None:
    """JAX's refusals of the stage axis (pipeline.py:86-97): it composes
    with data only."""
    if mesh.size('stage') > 1:
        for ax in AXES[2:]:
            if mesh.size(ax) > 1:
                raise ValueError('PP composes with the data axis only '
                                 f'(stage x data mesh); {ax}='
                                 f'{mesh.size(ax)}')
