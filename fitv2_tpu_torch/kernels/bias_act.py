"""Bias + activation (+ gain, clamp): StyleGAN's ``bias_act``.

Counterpart of fitv2_tpu/ops/bias_act.py, an XLA op there (one fused
``jnp`` expression, no Pallas kernel), so plain PyTorch here: the nine
activations with their default alpha and gain, a bias broadcast along
``dim``, then ``gain`` and a symmetric ``clamp``. Gradients of any order
come from autograd.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

_SQRT2 = math.sqrt(2.0)

# name -> (fn(x, alpha), default alpha, default gain)
ACTIVATION_FUNCS = {
    'linear': (lambda x, a: x, 0.0, 1.0),
    'relu': (lambda x, a: F.relu(x), 0.0, _SQRT2),
    'lrelu': (lambda x, a: F.leaky_relu(x, a), 0.2, _SQRT2),
    'tanh': (lambda x, a: torch.tanh(x), 0.0, 1.0),
    'sigmoid': (lambda x, a: torch.sigmoid(x), 0.0, 1.0),
    'elu': (lambda x, a: F.elu(x), 0.0, 1.0),
    'selu': (lambda x, a: F.selu(x), 0.0, 1.0),
    'softplus': (lambda x, a: F.softplus(x), 0.0, 1.0),
    'swish': (lambda x, a: F.silu(x), 0.0, _SQRT2),
}


def bias_act(x: Tensor, b: Optional[Tensor] = None, *, dim: int = 1,
             act: str = 'linear', alpha: Optional[float] = None,
             gain: Optional[float] = None,
             clamp: Optional[float] = None) -> Tensor:
    """y = clamp(gain * act(x + b), +-clamp). ``b`` (C,) broadcasts along
    ``dim``; a negative or None ``clamp`` means no clamp."""
    if act not in ACTIVATION_FUNCS:
        raise ValueError(f'unknown activation {act!r}')
    fn, def_alpha, def_gain = ACTIVATION_FUNCS[act]
    alpha = def_alpha if alpha is None else float(alpha)
    gain = def_gain if gain is None else float(gain)
    if b is not None:
        if b.dim() != 1 or b.shape[0] != x.shape[dim]:
            raise ValueError(f'bias {tuple(b.shape)} does not match axis '
                             f'{dim} of {tuple(x.shape)}')
        shape = [1] * x.dim()
        shape[dim] = -1
        x = x + b.reshape(shape)
    y = fn(x, alpha)
    if gain != 1.0:
        y = y * gain
    if clamp is not None and clamp >= 0:
        y = torch.clamp(y, -clamp, clamp)
    return y
