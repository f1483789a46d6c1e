"""Fixed-ladder flow samplers over ``model_fn(x, t) -> velocity`` closures.

Counterpart of the Euler family of fitv2_tpu/flow/samplers.py: plain Euler
over a time ladder, the training-free velocity-extrapolation sampler
(the model runs on every ``eval_every``-th step only) and the CFG wrapper
that builds the doubled batch. The ladder is a host-side float32 array;
time arithmetic is float32, as in JAX.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

Tensor = torch.Tensor
ModelFn = Callable[[Tensor, Tensor], Tensor]


def euler_ladder(steps: int) -> np.ndarray:
    """The (steps + 1,) float32 time ladder from 0 to 1 of the samplers.

    It equals ``jnp.linspace(0.0, 1.0, steps + 1)``, the ladder of JAX's
    sampler (fitv2_tpu/sample/pipeline.py:193), bit for bit:
    ``i * f32(1 / steps)`` in float32 with the last entry exactly 1
    (``torch.linspace`` rounds differently, 1-2 ulps off at most step
    counts)."""
    ladder = np.arange(steps + 1, dtype=np.float32) * (
        np.float32(1) / np.float32(steps))
    ladder[-1] = 1.0
    return ladder


def _t_vec(x: Tensor, t: np.float32) -> Tensor:
    return torch.full((x.shape[0],), float(t), dtype=torch.float32,
                      device=x.device)


def euler_sample(model_fn: ModelFn, x: Tensor, sigmas) -> Tensor:
    """x_{i+1} = x_i + (sigma_{i+1} - sigma_i) * v(x_i, sigma_i); sigmas is
    the (steps + 1,) ladder, typically ``euler_ladder(steps)``."""
    sig = np.asarray(sigmas, np.float32)
    for t_cur, t_next in zip(sig[:-1], sig[1:]):
        x = x + float(t_next - t_cur) * model_fn(x, _t_vec(x, t_cur))
    return x


def _safe_inv(dt: np.float32) -> np.float32:
    """Sign-preserving 1 / dt with |dt| clamped to 1e-8 (a descending ladder
    has dt < 0; clamping the signed value would flip the slope)."""
    return np.sign(dt) / np.maximum(np.abs(dt), np.float32(1e-8))


def euler_sample_extrapolated(model_fn: ModelFn, x: Tensor, sigmas,
                              eval_every: int = 2, order: int = 1) -> Tensor:
    """Euler over the whole ladder with the model run only on the first
    step of each block of ``eval_every`` steps; the other steps extrapolate
    the velocity in t from the last evaluations.

    order 1: v = v_e + (v_e - v_p) / (t_e - t_p) * (t - t_e) (linear through
    the last two evaluations); order 2 adds Newton's quadratic term through
    the last three. The first evaluations, with too few predecessors, use
    the lower order (v_e alone at first). A ladder that ``eval_every`` does
    not divide ends in a shorter block, one more model call."""
    if order not in (1, 2):
        raise ValueError(f'velocity extrapolation order must be 1 or 2, got '
                         f'{order}')
    if eval_every < 1:
        raise ValueError(f'eval_every must be >= 1, got {eval_every}')
    sig = np.asarray(sigmas, np.float32)
    pairs = np.stack([sig[:-1], sig[1:]], axis=-1)
    v_p = v_pp = None
    t_p = t_pp = np.float32(0.0)
    for start in range(0, len(pairs), eval_every):
        block = pairs[start:start + eval_every]
        t_e = block[0, 0]
        v_e = model_fn(x, _t_vec(x, t_e))
        f1 = f2 = None
        if v_p is not None:
            f1 = (v_e - v_p) * float(_safe_inv(t_e - t_p))
            if order == 2 and v_pp is not None:
                f01 = (v_p - v_pp) * float(_safe_inv(t_p - t_pp))
                f2 = (f1 - f01) * float(_safe_inv(t_e - t_pp))
        for t_cur, t_next in block:
            v = v_e
            if f1 is not None:
                v = v_e + f1 * float(t_cur - t_e)
            if f2 is not None:
                v = v + f2 * float(t_cur - t_e) * float(t_cur - t_p)
            x = x + float(t_next - t_cur) * v
        v_pp, t_pp, v_p, t_p = v_p, t_p, v_e, t_e
    return x


def cfg_model_fn(model_fn_doubled: ModelFn, cfg_scale: float,
                 num_channels: Optional[int] = None) -> ModelFn:
    """Single-batch CFG drift from a model over the doubled (2B) batch whose
    second half carries the null class: ``uncond + s * (cond - uncond)`` on
    the first ``num_channels`` channels (all by default); the others keep
    the conditional output."""
    def fn(x: Tensor, t: Tensor) -> Tensor:
        out = model_fn_doubled(torch.cat([x, x], dim=0),
                               torch.cat([t, t], dim=0))
        cond, uncond = out.chunk(2, dim=0)
        if num_channels is None:
            return uncond + cfg_scale * (cond - uncond)
        mixed = uncond[..., :num_channels] + cfg_scale * (
            cond[..., :num_channels] - uncond[..., :num_channels])
        return torch.cat([mixed, cond[..., num_channels:]], dim=-1)
    return fn
