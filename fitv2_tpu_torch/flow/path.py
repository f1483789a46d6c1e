"""Coupling-path plans for flow matching (ICPlan / VPCPlan / GVPCPlan).

Counterpart of fitv2_tpu/flow/path.py: alpha_t / sigma_t and their
derivatives along ``x_t = alpha_t * x1 + sigma_t * x0``, the SDE view's
drift and diffusion, and the velocity / score / noise conversions. Each
plan is a frozen dataclass of scalars whose methods take tensors.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

Tensor = torch.Tensor


def expand_t_like_x(t: Tensor, x: Tensor) -> Tensor:
    """Reshape (B,) time to broadcast against (B, ...) data."""
    return t.reshape(t.shape[:1] + (1,) * (x.dim() - 1))


@dataclasses.dataclass(frozen=True)
class ICPlan:
    """Linear coupling: alpha_t = t, sigma_t = 1 - t."""
    sigma: float = 0.0

    def compute_alpha_t(self, t: Tensor) -> Tuple[Tensor, Tensor]:
        return t, torch.ones_like(t)

    def compute_sigma_t(self, t: Tensor) -> Tuple[Tensor, Tensor]:
        return 1.0 - t, -torch.ones_like(t)

    def compute_d_alpha_alpha_ratio_t(self, t: Tensor) -> Tensor:
        return 1.0 / t

    def compute_drift(self, x: Tensor, t: Tensor) -> Tuple[Tensor, Tensor]:
        """Score-parametrized SDE drift: returns (-drift_mean, drift_var)."""
        t = expand_t_like_x(t, x)
        alpha_ratio = self.compute_d_alpha_alpha_ratio_t(t)
        sigma_t, d_sigma_t = self.compute_sigma_t(t)
        drift = alpha_ratio * x
        diffusion = alpha_ratio * (sigma_t ** 2) - sigma_t * d_sigma_t
        return -drift, diffusion

    def compute_diffusion(self, x: Tensor, t: Tensor, form: str = 'constant',
                          norm: float = 1.0) -> Tensor:
        t = expand_t_like_x(t, x)
        if form == 'constant':
            return torch.full_like(t, norm, dtype=x.dtype)
        if form == 'SBDM':
            return norm * self.compute_drift(x, t)[1]
        if form == 'sigma':
            return norm * self.compute_sigma_t(t)[0]
        if form == 'linear':
            return norm * (1.0 - t)
        if form == 'decreasing':
            return 0.25 * (norm * torch.cos(math.pi * t) + 1.0) ** 2
        if form == 'increasing-decreasing':
            return norm * torch.sin(math.pi * t) ** 2
        raise NotImplementedError(f'Diffusion form {form!r} not implemented')

    def get_score_from_velocity(self, velocity: Tensor, x: Tensor,
                                t: Tensor) -> Tensor:
        t = expand_t_like_x(t, x)
        alpha_t, d_alpha_t = self.compute_alpha_t(t)
        sigma_t, d_sigma_t = self.compute_sigma_t(t)
        reverse_alpha_ratio = alpha_t / d_alpha_t
        var = sigma_t ** 2 - reverse_alpha_ratio * d_sigma_t * sigma_t
        return (reverse_alpha_ratio * velocity - x) / var

    def get_noise_from_velocity(self, velocity: Tensor, x: Tensor,
                                t: Tensor) -> Tensor:
        t = expand_t_like_x(t, x)
        alpha_t, d_alpha_t = self.compute_alpha_t(t)
        sigma_t, d_sigma_t = self.compute_sigma_t(t)
        reverse_alpha_ratio = alpha_t / d_alpha_t
        var = reverse_alpha_ratio * d_sigma_t - sigma_t
        return (reverse_alpha_ratio * velocity - x) / var

    def get_velocity_from_score(self, score: Tensor, x: Tensor,
                                t: Tensor) -> Tensor:
        drift, var = self.compute_drift(x, t)
        return var * score - drift

    def compute_mu_t(self, t: Tensor, x0: Tensor, x1: Tensor) -> Tensor:
        t = expand_t_like_x(t, x1)
        alpha_t, _ = self.compute_alpha_t(t)
        sigma_t, _ = self.compute_sigma_t(t)
        return alpha_t * x1 + sigma_t * x0

    def compute_xt(self, t: Tensor, x0: Tensor, x1: Tensor) -> Tensor:
        return self.compute_mu_t(t, x0, x1)

    def compute_ut(self, t: Tensor, x0: Tensor, x1: Tensor,
                   xt: Tensor) -> Tensor:
        t = expand_t_like_x(t, x1)
        _, d_alpha_t = self.compute_alpha_t(t)
        _, d_sigma_t = self.compute_sigma_t(t)
        return d_alpha_t * x1 + d_sigma_t * x0

    def plan(self, t: Tensor, x0: Tensor, x1: Tensor):
        xt = self.compute_xt(t, x0, x1)
        ut = self.compute_ut(t, x0, x1, xt)
        return t, xt, ut


@dataclasses.dataclass(frozen=True)
class VPCPlan(ICPlan):
    """Variance-preserving path."""
    sigma_min: float = 0.1
    sigma_max: float = 20.0

    def log_mean_coeff(self, t: Tensor) -> Tensor:
        return (-0.25 * ((1 - t) ** 2) * (self.sigma_max - self.sigma_min)
                - 0.5 * (1 - t) * self.sigma_min)

    def d_log_mean_coeff(self, t: Tensor) -> Tensor:
        return (0.5 * (1 - t) * (self.sigma_max - self.sigma_min)
                + 0.5 * self.sigma_min)

    def compute_alpha_t(self, t):
        alpha_t = torch.exp(self.log_mean_coeff(t))
        return alpha_t, alpha_t * self.d_log_mean_coeff(t)

    def compute_sigma_t(self, t):
        p_sigma_t = 2 * self.log_mean_coeff(t)
        sigma_t = torch.sqrt(1 - torch.exp(p_sigma_t))
        d_sigma_t = (torch.exp(p_sigma_t) * (2 * self.d_log_mean_coeff(t))
                     / (-2 * sigma_t))
        return sigma_t, d_sigma_t

    def compute_d_alpha_alpha_ratio_t(self, t):
        return self.d_log_mean_coeff(t)

    def compute_drift(self, x, t):
        t = expand_t_like_x(t, x)
        beta_t = self.sigma_min + (1 - t) * (self.sigma_max - self.sigma_min)
        return -0.5 * beta_t * x, beta_t / 2


@dataclasses.dataclass(frozen=True)
class GVPCPlan(ICPlan):
    """Generalized VP: the trigonometric path."""

    def compute_alpha_t(self, t):
        return (torch.sin(t * math.pi / 2),
                math.pi / 2 * torch.cos(t * math.pi / 2))

    def compute_sigma_t(self, t):
        return (torch.cos(t * math.pi / 2),
                -math.pi / 2 * torch.sin(t * math.pi / 2))

    def compute_d_alpha_alpha_ratio_t(self, t):
        return math.pi / (2 * torch.tan(t * math.pi / 2))
