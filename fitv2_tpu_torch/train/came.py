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
"""

from __future__ import annotations

from typing import (TYPE_CHECKING, Callable, List, Mapping, Sequence, Tuple,
                    Union)

import torch

if TYPE_CHECKING:
    from fitv2_tpu_torch.ckpt.convert import JaxLeaf

Tensor = torch.Tensor
Schedule = Callable[[int], float]


def _approx_rsqrt(row: Tensor, col: Tensor) -> Tensor:
    """came_pytorch's rank-1 approximation of 1/sqrt(v)."""
    r = torch.rsqrt(row / row.mean(-1, keepdim=True))[..., :, None]
    return r * torch.rsqrt(col)[..., None, :]


class CAME(torch.optim.Optimizer):
    """optax ``chain(scale_by_came, add_decayed_weights, scale_by_lr)``.

    ``params``: the parameters by name; ``leaves``: JAX's leaves of the
    model (``ckpt.jax_leaves``), of which those over ``params`` are
    updated: every parameter must be in one, and a leaf that holds some of
    ``params`` must hold only them. ``lr`` is a rate or a ``step -> lr``
    schedule called with the count of updates applied so far (kept in the
    parameter group). ``betas`` (b1, b2, b3) and ``eps`` (eps1, eps2) as
    came_pytorch's."""

    def __init__(self, params: Mapping[str, Tensor],
                 leaves: Sequence[JaxLeaf],
                 lr: Union[float, Schedule] = 1e-4,
                 betas: Tuple[float, float, float] = (0.9, 0.999, 0.9999),
                 eps: Tuple[float, float] = (1e-30, 1e-16),
                 weight_decay: float = 0.0, clip_threshold: float = 1.0):
        self._params = dict(params)
        super().__init__(list(self._params.values()), dict(
            betas=tuple(betas), eps=tuple(eps), weight_decay=weight_decay,
            clip_threshold=clip_threshold, count=0))
        self.schedule = lr if callable(lr) else (lambda step: float(lr))
        self.leaves = []
        for leaf in leaves:
            held = [n in self._params for n in leaf.names]
            if any(held) and not all(held):
                raise ValueError(f'{leaf.path}: JAX holds {len(leaf.names)} '
                                 'parameters in one leaf; group them '
                                 'together')
            if all(held):
                self.leaves.append(leaf)
        if sorted(n for leaf in self.leaves for n in leaf.names) != sorted(
                self._params):
            raise ValueError('every parameter must be in exactly one leaf')

    def leaf_params(self, leaf: JaxLeaf) -> List[Tensor]:
        """The parameters of one of ``self.leaves``; its state is kept
        under the first."""
        return [self._params[n] for n in leaf.names]

    def _state(self, leaf: JaxLeaf, g: Tensor) -> dict:
        state = self.state[self._params[leaf.names[0]]]
        if not state:
            state['m'] = torch.zeros_like(g)
            if g.dim() >= 2:
                rows, cols = g.shape[:-1], g.shape[:-2] + g.shape[-1:]
                for k, shape in (('r_row', rows), ('r_col', cols),
                                 ('s_row', rows), ('s_col', cols)):
                    state[k] = g.new_zeros(shape)
            else:
                state['r_full'] = torch.zeros_like(g)
        return state

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError('CAME.step takes no closure')
        group = self.param_groups[0]
        lr = self.schedule(group['count'])
        group['count'] += 1
        b1, b2, b3 = group['betas']
        eps1, eps2 = group['eps']
        wd = group['weight_decay']
        for leaf in self.leaves:
            params = self.leaf_params(leaf)
            if any(p.grad is None for p in params):
                continue
            g = leaf.to_jax([p.grad for p in params]).float()
            st = self._state(leaf, g)
            gsq = g * g + eps1
            if g.dim() >= 2:
                st['r_row'].copy_(b2 * st['r_row'] + (1 - b2) * gsq.mean(-1))
                st['r_col'].copy_(b2 * st['r_col'] + (1 - b2) * gsq.mean(-2))
                u = _approx_rsqrt(st['r_row'], st['r_col']) * g
            else:
                st['r_full'].copy_(b2 * st['r_full'] + (1 - b2) * gsq)
                u = g * torch.rsqrt(st['r_full'])
            rms = torch.sqrt(torch.mean(u * u))
            u = u / torch.clamp(rms / group['clip_threshold'], min=1.0)
            st['m'].copy_(b1 * st['m'] + (1 - b1) * u)
            if g.dim() >= 2:
                res = (u - st['m']) ** 2 + eps2
                st['s_row'].copy_(b3 * st['s_row'] + (1 - b3) * res.mean(-1))
                st['s_col'].copy_(b3 * st['s_col'] + (1 - b3) * res.mean(-2))
                update = _approx_rsqrt(st['s_row'], st['s_col']) * st['m']
            else:
                update = st['m']
            for p, u_p in zip(params, leaf.from_jax(update)):
                if wd > 0:
                    u_p = u_p + wd * p
                p.add_(u_p * -lr)
