"""Flow-matching transport: the training loss and the samplers' drift.

Counterpart of fitv2_tpu/flow/transport.py. ``Transport`` is a frozen
dataclass of static config; ``training_losses(model_fn, x1, mask)`` takes
the model as a ``model_fn(xt, t) -> prediction`` closure, and
``get_drift`` / ``get_score`` wrap such a closure for the ODE/SDE
samplers (flow/samplers.py). The draws of t and x0 come from
an explicit CPU ``torch.Generator`` (so they do not depend on the device),
or are passed in: ``jax.random`` and torch streams never match, and the
parity tests give both packages the same t and x0. The masked loss with
its N / nnz reweighting is computed in fp32.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from fitv2_tpu_torch.flow import path as path_lib
from fitv2_tpu_torch.flow.path import expand_t_like_x

Tensor = torch.Tensor


class ModelType(enum.Enum):
    NOISE = enum.auto()
    SCORE = enum.auto()
    VELOCITY = enum.auto()


class PathType(enum.Enum):
    LINEAR = enum.auto()
    GVP = enum.auto()
    VP = enum.auto()


class WeightType(enum.Enum):
    NONE = enum.auto()
    VELOCITY = enum.auto()
    LIKELIHOOD = enum.auto()


class SNRType(enum.Enum):
    UNIFORM = enum.auto()
    LOGNORM = enum.auto()


_PATHS = {
    PathType.LINEAR: path_lib.ICPlan,
    PathType.GVP: path_lib.GVPCPlan,
    PathType.VP: path_lib.VPCPlan,
}


def mean_flat(x: Tensor) -> Tensor:
    """Mean over all non-batch dims."""
    return x.mean(dim=tuple(range(1, x.dim())))


def masked_loss_ratio(mask: Optional[Tensor], x: Tensor
                      ) -> Tuple[Tensor, Tensor]:
    """Pad mask and N / nnz reweighting. mask: (B, N) 0/1 or None; returns
    (mask_b, ratio): mask_b broadcasts against x (B, N, C), ratio is (B,)
    float32."""
    if mask is None:
        return (torch.ones((), dtype=x.dtype, device=x.device),
                torch.ones((x.shape[0],), device=x.device))
    ratio = mask.shape[-1] / torch.count_nonzero(mask, dim=-1).float()
    return mask[..., None].to(x.dtype), ratio


@dataclasses.dataclass(frozen=True)
class Transport:
    """Static flow-matching config."""
    model_type: ModelType = ModelType.VELOCITY
    path_type: PathType = PathType.LINEAR
    loss_type: WeightType = WeightType.NONE
    train_eps: float = 0.0
    sample_eps: float = 0.0
    snr_type: SNRType = SNRType.UNIFORM

    @property
    def path_sampler(self) -> path_lib.ICPlan:
        return _PATHS[self.path_type]()

    def check_interval(self, train_eps: float, sample_eps: float, *,
                       diffusion_form: str = 'SBDM', sde: bool = False,
                       reverse: bool = False, eval: bool = False,
                       last_step_size: float = 0.0) -> Tuple[float, float]:
        t0, t1 = 0.0, 1.0
        eps = train_eps if not eval else sample_eps
        if self.path_type == PathType.VP:
            t1 = 1 - eps if (not sde or last_step_size == 0) \
                else 1 - last_step_size
        elif self.model_type != ModelType.VELOCITY or sde:
            t0 = eps if (diffusion_form == 'SBDM' and sde) \
                or self.model_type != ModelType.VELOCITY else 0
            t1 = 1 - eps if (not sde or last_step_size == 0) \
                else 1 - last_step_size
        if reverse:
            t0, t1 = 1 - t0, 1 - t1
        return t0, t1

    def sample(self, x1: Tensor, generator: Optional[torch.Generator] = None
               ) -> Tuple[Tensor, Tensor, Tensor]:
        """(t, x0, x1): t (B,) uniform, or the sigmoid of a standard normal
        (lognorm), on the training interval; x0 standard normal like x1.
        Drawn on the CPU from ``generator`` (t first), then moved to x1's
        device and dtype."""
        b = x1.shape[0]
        t0, t1 = self.check_interval(self.train_eps, self.sample_eps)
        if self.snr_type == SNRType.UNIFORM:
            t = torch.rand((b,), generator=generator) * (t1 - t0) + t0
        elif self.snr_type == SNRType.LOGNORM:
            u = torch.randn((b,), generator=generator)
            t = torch.sigmoid(u) * (t1 - t0) + t0
        else:
            raise ValueError(f'Unknown snr type: {self.snr_type}')
        x0 = torch.randn(tuple(x1.shape), generator=generator)
        return (t.to(x1.device, x1.dtype), x0.to(x1.device, x1.dtype), x1)

    def training_losses(self, model_fn: Callable[[Tensor, Tensor], Tensor],
                        x1: Tensor, mask: Optional[Tensor] = None,
                        generator: Optional[torch.Generator] = None,
                        t: Optional[Tensor] = None,
                        x0: Optional[Tensor] = None) -> Dict[str, Tensor]:
        """Masked flow-matching loss.

        model_fn: (xt, t) -> prediction with all conditioning bound; mask:
        (B, N) token validity or None. t and x0 are drawn (``sample``)
        unless given. Returns {'loss': (B,), 'pred': model output, 't': t}.
        """
        if t is None or x0 is None:
            t_drawn, x0_drawn, _ = self.sample(x1, generator)
            t = t_drawn if t is None else t
            x0 = x0_drawn if x0 is None else x0
        t = t.to(x1.device, x1.dtype)
        x0 = x0.to(x1.device, x1.dtype)
        plan = self.path_sampler
        t, xt, ut = plan.plan(t, x0, x1)
        pred = model_fn(xt, t)
        if pred.shape != xt.shape:
            raise ValueError(f'prediction {tuple(pred.shape)} != x_t '
                             f'{tuple(xt.shape)}')
        mask_b, ratio = masked_loss_ratio(mask, x1)
        p32 = pred.float()
        if self.model_type == ModelType.VELOCITY:
            err = (p32 - ut.float()) * mask_b
            loss = mean_flat(err ** 2) * ratio
        else:
            _, drift_var = plan.compute_drift(xt, t)
            sigma_t, _ = plan.compute_sigma_t(expand_t_like_x(t, xt))
            if self.loss_type == WeightType.VELOCITY:
                weight = (drift_var / sigma_t) ** 2
            elif self.loss_type == WeightType.LIKELIHOOD:
                weight = drift_var / (sigma_t ** 2)
            else:
                weight = 1.0
            if self.model_type == ModelType.NOISE:
                err = (p32 - x0.float()) * mask_b
            else:  # SCORE
                err = (p32 * sigma_t + x0.float()) * mask_b
            loss = mean_flat(weight * err ** 2) * ratio
        return {'loss': loss, 'pred': pred, 't': t}

    def get_drift(self) -> Callable:
        """Probability-flow-ODE drift: (x, t, model_fn) -> dx/dt."""
        plan = self.path_sampler

        def score_ode(x, t, model_fn):
            drift_mean, drift_var = plan.compute_drift(x, t)
            return -drift_mean + drift_var * model_fn(x, t)

        def noise_ode(x, t, model_fn):
            drift_mean, drift_var = plan.compute_drift(x, t)
            sigma_t, _ = plan.compute_sigma_t(expand_t_like_x(t, x))
            return -drift_mean + drift_var * (model_fn(x, t) / -sigma_t)

        def velocity_ode(x, t, model_fn):
            return model_fn(x, t)

        return {ModelType.NOISE: noise_ode, ModelType.SCORE: score_ode,
                ModelType.VELOCITY: velocity_ode}[self.model_type]

    def get_score(self) -> Callable:
        """Score of x_t: (x, t, model_fn) -> grad log p_t(x)."""
        plan = self.path_sampler
        if self.model_type == ModelType.NOISE:
            return lambda x, t, m: m(x, t) / -plan.compute_sigma_t(
                expand_t_like_x(t, x))[0]
        if self.model_type == ModelType.SCORE:
            return lambda x, t, m: m(x, t)
        return lambda x, t, m: plan.get_score_from_velocity(m(x, t), x, t)

    def prior_logp(self, z: Tensor) -> Tensor:
        """log N(z; 0, I) per sample, float32."""
        n = math.prod(z.shape[1:])
        # float32 arithmetic, as JAX's -n / 2 * jnp.log(2 pi)
        const = np.float32(-n / 2.0) * np.log(np.float32(2 * math.pi))
        z32 = z.float().reshape(z.shape[0], -1)
        return float(const) - (z32 ** 2).sum(-1) / 2.0


def create_transport(path_type: str = 'Linear', prediction: str = 'velocity',
                     loss_weight: Optional[str] = None,
                     train_eps: Optional[float] = None,
                     sample_eps: Optional[float] = None,
                     snr_type: str = 'uniform') -> Transport:
    """The reference API's factory (the JAX package's create_transport)."""
    model_type = {'noise': ModelType.NOISE, 'score': ModelType.SCORE}.get(
        prediction, ModelType.VELOCITY)
    loss_type = {'velocity': WeightType.VELOCITY,
                 'likelihood': WeightType.LIKELIHOOD}.get(
        loss_weight, WeightType.NONE)
    if snr_type not in ('lognorm', 'uniform'):
        raise ValueError(f'Invalid snr type {snr_type}')
    snr = SNRType.LOGNORM if snr_type == 'lognorm' else SNRType.UNIFORM
    ptype = {'Linear': PathType.LINEAR, 'GVP': PathType.GVP,
             'VP': PathType.VP}[path_type]
    if ptype == PathType.VP:
        train_eps = 1e-5 if train_eps is None else train_eps
        sample_eps = 1e-3 if sample_eps is None else sample_eps
    elif model_type != ModelType.VELOCITY:
        train_eps = 1e-3 if train_eps is None else train_eps
        sample_eps = 1e-3 if sample_eps is None else sample_eps
    else:
        train_eps = 0.0 if train_eps is None else train_eps
        sample_eps = 0.0 if sample_eps is None else sample_eps
    return Transport(model_type=model_type, path_type=ptype,
                     loss_type=loss_type, train_eps=train_eps,
                     sample_eps=sample_eps, snr_type=snr)
