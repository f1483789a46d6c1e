"""CAME (Confidence-guided Adaptive Memory-Efficient optimization).

Counterpart of fitv2_tpu/train/came.py, the came_pytorch update as optax
runs it, per leaf of the parameter tree:

  v_t  = b2 v_{t-1} + (1-b2) (g^2 + eps1)   (factored row/col for rank >= 2)
  u_t  = g * rsqrt_approx(v_t)
  u_t  = u_t / max(1, RMS(u_t) / clip)       (RMS clipping of the update)
  m_t  = b1 m_{t-1} + (1-b1) u_t             (momentum of the clipped update)
  res  = (u_t - m_t)^2 + eps2
  s_t  = b3 s_{t-1} + (1-b3) res             (factored; rank >= 2 only)
  step = rsqrt_approx(s_t) * m_t             (rank < 2: step = m_t)
  p   -= lr * (step + wd * p)                (decay scaled by lr)

A leaf is JAX's, not a torch parameter (``ckpt.jax_leaves``): the factored
moments run over the last two axes of JAX's layout (a Dense kernel is the
transpose of an ``nn.Linear`` weight), and a block parameter that JAX
stacks over depth is one leaf: its RMS spans the stack, and a stacked bias
is a factored (depth, D) matrix. Each step stacks such a leaf's gradients
in JAX's layout, updates it as optax does, and writes the slices back; its
state (fp32) is kept in that layout under the leaf's first parameter.

Under model sharding (``layout``, a ``parallel.sharding.ShardedLayout``)
each rank updates the part of each leaf that it holds
(``JaxLeaf.part``: FSDP2's chunks, the tensor split, a stage's blocks).
Every statistic that reduces over an axis some ranks split is a sum of
the ranks' partial sums divided by the whole count: the row and column
means and the RMS. A rank places its partial row and column sums at its
own positions of a zero vector of the whole leaf's, and the vectors are
summed over the axes that split the leaf, one flat all-reduce a mesh axis
for every leaf at once (three a step: the squares, the RMS, the
residuals), so that ``m`` and ``r_full`` are sharded like the parameter
while the factored vectors (r_row, r_col, s_row, s_col: a few per row and
column) are whole, and alike, on every rank, which reads its own entries.
``_approx_rsqrt``'s mean of the row vector then needs no collective. The
state of a leaf is kept under its path.
"""

from __future__ import annotations

import math
from typing import (TYPE_CHECKING, Callable, List, Mapping, Optional,
                    Sequence, Tuple, Union)

import torch

from fitv2_tpu_torch.parallel.sharding import flat_sum

if TYPE_CHECKING:
    from fitv2_tpu_torch.ckpt.convert import JaxLeaf, LeafPart

Tensor = torch.Tensor
Schedule = Callable[[int], float]


def _stat_axes(nd: int) -> Tuple[List[int], List[int]]:
    """The axes of a rank-``nd`` leaf's row and column statistics."""
    return list(range(nd - 1)), list(range(nd - 2)) + [nd - 1]


def _approx_rsqrt(part: LeafPart, row: Tensor, col: Tensor) -> Tensor:
    """came_pytorch's rank-1 approximation of 1/sqrt(v) from the whole
    row and column statistics, at ``part``'s entries."""
    rows, cols = _stat_axes(len(part.shape))
    r = torch.rsqrt(row / row.mean(-1, keepdim=True))
    return (part.take(r, rows)[..., :, None]
            * part.take(torch.rsqrt(col), cols)[..., None, :])


class CAME(torch.optim.Optimizer):
    """optax ``chain(scale_by_came, add_decayed_weights, scale_by_lr)``.

    ``params``: the parameters by name; ``leaves``: JAX's leaves of the
    model (``ckpt.jax_leaves``), of which those over ``params`` are
    updated: every parameter must be in one, and a leaf that holds some of
    ``params`` must hold only them. ``lr`` is a rate or a ``step -> lr``
    schedule called with the count of updates applied so far (kept in the
    parameter group). ``betas`` (b1, b2, b3) and ``eps`` (eps1, eps2) as
    came_pytorch's.

    ``layout``: the model is sharded over its mesh, and ``params`` are
    this rank's local tensors; ``names`` are then every parameter the
    optimizer updates over the mesh (default: every one of
    ``layout.names``), held here or not. Every rank steps together."""

    def __init__(self, params: Mapping[str, Tensor],
                 leaves: Sequence[JaxLeaf],
                 lr: Union[float, Schedule] = 1e-4,
                 betas: Tuple[float, float, float] = (0.9, 0.999, 0.9999),
                 eps: Tuple[float, float] = (1e-30, 1e-16),
                 weight_decay: float = 0.0, clip_threshold: float = 1.0,
                 layout=None, names: Optional[Sequence[str]] = None):
        self._params = dict(params)
        super().__init__([{'params': list(self._params.values())}], dict(
            betas=tuple(betas), eps=tuple(eps), weight_decay=weight_decay,
            clip_threshold=clip_threshold, count=0))
        self.schedule = lr if callable(lr) else (lambda step: float(lr))
        self.layout = layout
        if names is None:
            names = self._params if layout is None else layout.names
        names = set(names)
        if not set(self._params) <= names:
            raise ValueError('a parameter of params is not in names')
        self.leaves = []
        for leaf in leaves:
            held = [n in names for n in leaf.names]
            if any(held) and not all(held):
                raise ValueError(f'{leaf.path}: JAX holds {len(leaf.names)} '
                                 'parameters in one leaf; group them '
                                 'together')
            if all(held):
                self.leaves.append(leaf)
        if sorted(n for leaf in self.leaves for n in leaf.names) != sorted(
                names):
            raise ValueError('every parameter must be in exactly one leaf')
        shapes = ({n: p.shape for n, p in self._params.items()}
                  if layout is None else layout.shapes)
        self.parts = [leaf.part(shapes, layout) for leaf in self.leaves]

    def leaf_params(self, leaf: JaxLeaf) -> List[Tensor]:
        """The parameters of one of ``self.leaves`` that this rank holds;
        without a layout its state is kept under the first."""
        return [self._params[n] for n in leaf.names if n in self._params]

    def leaf_state(self, leaf: JaxLeaf) -> dict:
        """The state of one of ``self.leaves`` (empty before a step)."""
        key = leaf.path if self.layout is not None else \
            self._params[leaf.names[0]]
        return self.state[key]

    def _device(self) -> torch.device:
        if self.layout is not None:
            return self.layout._device()
        return next(iter(self._params.values())).device

    def _sum(self, items: List[Tuple[Tensor, Tuple[str, ...]]]) -> None:
        """Each tensor summed in place over the mesh axes beside it."""
        if self.layout is None:
            return
        mesh = self.layout.mesh
        for axis in ('fsdp', 'tensor', 'stage'):
            if mesh.size(axis) > 1:
                flat_sum([t for t, split in items if axis in split],
                         mesh.group(axis))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError('CAME.step takes no closure')
        group = self.param_groups[0]
        lr = self.schedule(group['count'])
        group['count'] += 1
        b1, b2, b3 = group['betas']
        eps1, eps2 = group['eps']
        wd, clip = group['weight_decay'], group['clip_threshold']
        device = self._device()
        todo = []
        for leaf, part in zip(self.leaves, self.parts):
            params = self.leaf_params(leaf)
            if any(p.grad is None for p in params):
                if self.layout is not None:
                    raise RuntimeError(f'{leaf.path}: no gradient')
                continue
            todo.append((leaf, part, params))

        def grad(leaf, params):  # stacked again each pass: no held copy
            if not params:
                return None
            return leaf.to_jax([p.grad for p in params]).float()

        def zeros(part, axes):
            return torch.zeros([part.shape[a] for a in axes], device=device)

        # 1. the squares' row and column sums
        sums = []
        for leaf, part, params in todo:
            st = self.leaf_state(leaf)
            g = grad(leaf, params)
            nd = len(part.shape)
            if not st:
                if g is not None:
                    st['m'] = torch.zeros_like(g)
                if nd >= 2:
                    rows, cols = _stat_axes(nd)
                    for k, axes in (('r_row', rows), ('r_col', cols),
                                    ('s_row', rows), ('s_col', cols)):
                        st[k] = zeros(part, axes)
                elif g is not None:
                    st['r_full'] = torch.zeros_like(g)
            if nd >= 2:
                rows, cols = _stat_axes(nd)
                gsq = None if g is None else g * g + eps1
                sums += [(part.place(st['r_row'], rows, None if g is None
                                     else gsq.sum(-1)), part.split),
                         (part.place(st['r_col'], cols, None if g is None
                                     else gsq.sum(-2)), part.split)]
        self._sum(sums)
        sums = iter(sums)

        # 2. the second moments, then the RMS of the normalised update
        squares = []
        for leaf, part, params in todo:
            st = self.leaf_state(leaf)
            g = grad(leaf, params)
            if len(part.shape) >= 2:
                row, col = next(sums)[0], next(sums)[0]
                st['r_row'].copy_(b2 * st['r_row']
                                  + (1 - b2) * (row / part.shape[-1]))
                st['r_col'].copy_(b2 * st['r_col']
                                  + (1 - b2) * (col / part.shape[-2]))
            elif g is not None:
                st['r_full'].copy_(b2 * st['r_full']
                                   + (1 - b2) * (g * g + eps1))
            u = self._normalised(part, st, g)
            squares.append(((u * u).sum() if u is not None
                            else torch.zeros((), device=device), part.split))
        self._sum(squares)

        # 3. the clipped update, its momentum and the residuals' sums
        sums = []
        for (leaf, part, params), (ss, _) in zip(todo, squares):
            st = self.leaf_state(leaf)
            u = self._normalised(part, st, grad(leaf, params))
            nd = len(part.shape)
            if u is not None:
                rms = torch.sqrt(ss / math.prod(part.shape))
                u = u / torch.clamp(rms / clip, min=1.0)
                st['m'].copy_(b1 * st['m'] + (1 - b1) * u)
            if nd >= 2:
                rows, cols = _stat_axes(nd)
                res = None if u is None else (u - st['m']) ** 2 + eps2
                sums += [(part.place(st['s_row'], rows, None if u is None
                                     else res.sum(-1)), part.split),
                         (part.place(st['s_col'], cols, None if u is None
                                     else res.sum(-2)), part.split)]
        self._sum(sums)
        sums = iter(sums)

        # 4. the confidence-scaled step
        for leaf, part, params in todo:
            st = self.leaf_state(leaf)
            if len(part.shape) >= 2:
                row, col = next(sums)[0], next(sums)[0]
                st['s_row'].copy_(b3 * st['s_row']
                                  + (1 - b3) * (row / part.shape[-1]))
                st['s_col'].copy_(b3 * st['s_col']
                                  + (1 - b3) * (col / part.shape[-2]))
                if not params:
                    continue
                update = _approx_rsqrt(part, st['s_row'], st['s_col']) \
                    * st['m']
            elif not params:
                continue
            else:
                update = st['m']
            for p, u_p in zip(params, leaf.from_jax(update)):
                if wd > 0:
                    u_p = u_p + wd * p
                p.add_(u_p * -lr)

    @staticmethod
    def _normalised(part: LeafPart, st: dict, g: Optional[Tensor]
                    ) -> Optional[Tensor]:
        """g times the approximate 1/sqrt of its second moment."""
        if g is None:
            return None
        if len(part.shape) >= 2:
            return _approx_rsqrt(part, st['r_row'], st['r_col']) * g
        return g * torch.rsqrt(st['r_full'])

