"""GPipe pipeline parallelism over the FiT block stack (the 'stage' axis).

Counterpart of fitv2_tpu/parallel/pipeline.py. JAX shards the depth-D
stacked block parameters D/S a device over 'stage' and runs the GPipe
schedule in a ``shard_map``: M microbatches through S stages in M + S - 1
ticks, ``ppermute`` between neighbours, then a masked ``psum`` that gives
every stage the last stage's output. The port runs the same schedule as
one autograd Function (``_GPipeTrunk``) in every process of a stage
group:

- forward: stage s runs its D/S blocks on microbatch ``tick - s`` at each
  tick, receiving it from stage s - 1 and sending its output to s + 1
  (one send/recv pair a tick, through the host under gloo, comms.py);
  the last stage's outputs are then broadcast to the group;
- backward: the ticks in reverse, each stage running its blocks' backward
  on microbatch ``M - 1 - (tick - (S - 1 - s))`` with the output gradient
  from stage s + 1 (the last stage: the loss's), and sending its input
  gradient to s - 1.

The pre/post graph (``embed_pre_trunk``, ``finalize_post_trunk``) runs
replicated on every rank, as in JAX. c and the global adaLN term feed
every block: each stage's Function returns their gradient from its own
blocks, and the step sums the gradients of the parameters every stage
holds over the stage group (parallel/sharding.py ``reduce_grads``). So
that the post graph, computed alike on every stage, counts once, only the
last stage keeps its output's gradient (``comms.keep_grad``).

Each rank holds its own blocks only (``make_pipelined_forward`` moves the
others to the meta device): about 1/S of the block stack, and the
optimizer moments and EMA follow (``pipeline_param_shardings``,
``pipeline_opt_shardings``).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn

from fitv2_tpu_torch.parallel import comms
from fitv2_tpu_torch.parallel.mesh import Mesh

Tensor = torch.Tensor


def _block_owner(model: nn.Module, mesh: Mesh) -> Dict[int, int]:
    """Block index -> the stage that runs it (depth/S blocks a stage, in
    order)."""
    S = mesh.size('stage')
    if model.depth % S:
        raise ValueError(f'depth {model.depth} does not split into {S} '
                         'stages')
    per = model.depth // S
    return {i: i // per for i in range(model.depth)}


def pipeline_param_shardings(mesh: Mesh, model: nn.Module
                             ) -> Dict[str, Optional[int]]:
    """Parameter name -> the stage that holds it: a block's parameters
    its stage's, every other None (each stage holds it)."""
    owner = _block_owner(model, mesh)
    out = {}
    for name, _ in model.named_parameters():
        parts = name.split('.')
        out[name] = owner[int(parts[1])] if parts[0] == 'blocks' else None
    return out


# the optimizer state's placement: each parameter's moments and
# accumulators on the stage that holds the parameter
pipeline_opt_shardings = pipeline_param_shardings


class GPipe:
    """The schedule of one stage: ``n_microbatches`` over the stage group
    of ``mesh``; this rank runs blocks [lo, hi)."""

    def __init__(self, mesh: Mesh, n_microbatches: int, depth: int):
        self.mesh = mesh
        self.M = n_microbatches
        self.S = mesh.size('stage')
        self.stage = mesh.coordinate('stage')
        self.group = mesh.group('stage')
        per = depth // self.S
        self.lo, self.hi = self.stage * per, (self.stage + 1) * per

    def __deepcopy__(self, memo):
        return self

    @property
    def last(self) -> bool:
        return self.stage == self.S - 1

    def run(self, model, x: Tensor, c: Tensor, mask, cos, sin,
            global_adaln) -> Tensor:
        """The trunk's output (B, N, D), whole on every stage."""
        ga = global_adaln if isinstance(global_adaln, Tensor) else None
        if x.shape[0] % self.M:
            raise ValueError(f'batch {x.shape[0]} does not split into '
                             f'{self.M} microbatches')
        return _GPipeTrunk.apply(self, model, torch.is_grad_enabled(), x, c,
                                 ga, mask, cos, sin)

    def output(self, out: Tensor) -> Tensor:
        return comms.keep_grad(out, self.last)


def _mb(t, m: int, size: int):
    return None if t is None else t[m * size:(m + 1) * size]


class _GPipeTrunk(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pipe: GPipe, model, grad: bool, x, c, ga, mask, cos,
                sin):
        s, S, M = pipe.stage, pipe.S, pipe.M
        mb = x.shape[0] // M
        blocks = list(model.blocks)[pipe.lo:pipe.hi]
        x_in = x.detach().requires_grad_(grad and s == 0)
        c_in = c.detach().requires_grad_(grad)
        ga_in = None if ga is None else ga.detach().requires_grad_(grad)
        ins: List[Optional[Tensor]] = [None] * M
        outs: List[Optional[Tensor]] = [None] * M
        with torch.set_grad_enabled(grad):
            for tick in range(M + S - 1):
                m = tick - s
                if not 0 <= m < M:
                    continue
                if s == 0:
                    h = _mb(x_in, m, mb)
                else:
                    h = comms.recv(x[:mb], s - 1, pipe.group)
                    h.requires_grad_(grad)
                ins[m] = h
                ga_m = 0.0 if ga_in is None else _mb(ga_in, m, mb)
                y = model.run_blocks(blocks, h, _mb(c_in, m, mb),
                                     _mb(mask, m, mb), _mb(cos, m, mb),
                                     _mb(sin, m, mb), ga_m)
                outs[m] = y
                if s < S - 1:
                    comms.send(y, s + 1, pipe.group)
        trunk = torch.cat(outs).detach() if pipe.last else \
            torch.empty_like(x)
        trunk = comms.broadcast(trunk, S - 1, pipe.group)
        ctx.pipe, ctx.mb = pipe, mb
        ctx.state = (x_in, c_in, ga_in, ins, outs)
        return trunk

    @staticmethod
    def backward(ctx, g):
        pipe, mb = ctx.pipe, ctx.mb
        s, S, M = pipe.stage, pipe.S, pipe.M
        x_in, c_in, ga_in, ins, outs = ctx.state
        with torch.enable_grad():
            for tick in range(M + S - 1):
                k = tick - (S - 1 - s)
                if not 0 <= k < M:
                    continue
                m = M - 1 - k
                gy = _mb(g, m, mb) if pipe.last else \
                    comms.recv(outs[m], s + 1, pipe.group)
                torch.autograd.backward(outs[m], gy.to(outs[m].dtype))
                if s > 0:
                    comms.send(ins[m].grad, s - 1, pipe.group)
                outs[m] = ins[m] = None
        ctx.state = None
        gx = x_in.grad if s == 0 else torch.zeros_like(x_in)
        return (None, None, None, gx, c_in.grad,
                None if ga_in is None else ga_in.grad, None, None, None)


def make_pipelined_forward(model: nn.Module, mesh: Mesh,
                           n_microbatches: int):
    """Run ``model``'s block stack under the GPipe schedule on ``mesh``'s
    stage axis; returns the model's forward, ``fwd(x, t, y, grid, mask,
    size, ...) -> (B, N, p**2*C_out)``, whole on every stage, as
    ``model`` computes it. The blocks this rank does not run move to the
    meta device. JAX's refusals hold: the bf16/fp32 path only (no int8),
    no ``sequence_mesh``, and a stage axis that composes with data only.
    JAX's ``train`` flag has no counterpart: the forward reads autograd's
    mode."""
    from fitv2_tpu_torch.parallel.sharding import check_axes
    if getattr(model, 'gemm_precision', 'bf16') != 'bf16':
        raise ValueError('pipeline supports the bf16/fp32 parity path only')
    if getattr(model, 'sequence_mesh', None) is not None:
        raise ValueError('PP does not thread constrain_sequence; use SP or '
                         'PP, not both')
    check_axes(mesh)
    owner = _block_owner(model, mesh)
    stage = mesh.coordinate('stage')
    for i, block in enumerate(model.blocks):
        if owner[i] != stage:
            block.to_empty(device='meta')
    model.pipeline = GPipe(mesh, n_microbatches, model.depth)
    return model.forward
