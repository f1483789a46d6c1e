"""Flow-matching Euler discrete scheduler: sigma ladders and the step rule.

Counterpart of fitv2_tpu/sched/flow_match.py (the diffusers
FlowMatchEulerDiscreteScheduler as a function library): the ladders are
built on the host with numpy once per sampling run, exactly as there
(dynamic time shifting, a base ``shift``, a stretched terminal, the
karras, exponential and beta ladders, ``invert_sigmas`` for FiTv2's
ascending 0 -> 1 convention), and ``euler_step`` is one tensor update.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class FlowMatchEulerConfig:
    num_train_timesteps: int = 1000
    shift: float = 1.0
    use_dynamic_shifting: bool = False
    base_shift: float = 0.5
    max_shift: float = 1.15
    base_image_seq_len: int = 256
    max_image_seq_len: int = 4096
    invert_sigmas: bool = False
    shift_terminal: Optional[float] = None
    use_karras_sigmas: bool = False
    use_exponential_sigmas: bool = False
    use_beta_sigmas: bool = False
    stochastic_sampling: bool = False


def time_shift(mu: float, sigma: float, t: np.ndarray) -> np.ndarray:
    """Dynamic shifting: exp(mu) / (exp(mu) + (1/t - 1)^sigma)."""
    return math.exp(mu) / (math.exp(mu) + (1 / t - 1) ** sigma)


def calculate_shift(image_seq_len: int, base_seq_len: int = 256,
                    max_seq_len: int = 4096, base_shift: float = 0.5,
                    max_shift: float = 1.15) -> float:
    """Resolution-dependent mu for dynamic shifting (diffusers convention)."""
    m = (max_shift - base_shift) / (max_seq_len - base_seq_len)
    b = base_shift - m * base_seq_len
    return image_seq_len * m + b


def _stretch_shift_to_terminal(sigmas: np.ndarray, terminal: float
                               ) -> np.ndarray:
    """Stretch the ladder so that its last sigma is ``terminal``."""
    one_minus = 1 - sigmas
    scale = one_minus[-1] / (1 - terminal)
    return 1 - one_minus / scale


def karras_sigmas(sigmas: np.ndarray, num_steps: int, rho: float = 7.0
                  ) -> np.ndarray:
    sigma_min, sigma_max = float(sigmas[-1]), float(sigmas[0])
    ramp = np.linspace(0, 1, num_steps)
    min_inv_rho = sigma_min ** (1 / rho)
    max_inv_rho = sigma_max ** (1 / rho)
    return (max_inv_rho + ramp * (min_inv_rho - max_inv_rho)) ** rho


def exponential_sigmas(sigmas: np.ndarray, num_steps: int) -> np.ndarray:
    sigma_min, sigma_max = float(sigmas[-1]), float(sigmas[0])
    return np.exp(np.linspace(math.log(sigma_max), math.log(sigma_min),
                              num_steps))


def beta_sigmas(sigmas: np.ndarray, num_steps: int, alpha: float = 0.6,
                beta: float = 0.6) -> np.ndarray:
    """Beta-distribution-spaced ladder (arXiv 2407.12173 convention)."""
    import scipy.stats
    sigma_min, sigma_max = float(sigmas[-1]), float(sigmas[0])
    ppfs = scipy.stats.beta.ppf(1 - np.linspace(0, 1, num_steps), alpha, beta)
    return np.array([sigma_min + p * (sigma_max - sigma_min) for p in ppfs])


def set_timesteps(cfg: FlowMatchEulerConfig, num_inference_steps: int,
                  mu: Optional[float] = None,
                  sigmas: Optional[np.ndarray] = None,
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """(timesteps, sigmas) float32 ladders; sigmas has a trailing terminal
    entry. Descending 1 -> ~0 by default, ascending with
    ``invert_sigmas``."""
    if cfg.use_dynamic_shifting and mu is None:
        raise ValueError('dynamic shifting requires mu')
    if sigmas is None:
        sigmas = np.linspace(1.0, 1.0 / cfg.num_train_timesteps,
                             num_inference_steps)
    if cfg.use_dynamic_shifting:
        sigmas = time_shift(mu, 1.0, sigmas)
    else:
        sigmas = cfg.shift * sigmas / (1 + (cfg.shift - 1) * sigmas)
    if cfg.shift_terminal is not None:
        sigmas = _stretch_shift_to_terminal(sigmas, cfg.shift_terminal)
    if cfg.use_karras_sigmas:
        sigmas = karras_sigmas(sigmas, num_inference_steps)
    elif cfg.use_exponential_sigmas:
        sigmas = exponential_sigmas(sigmas, num_inference_steps)
    elif cfg.use_beta_sigmas:
        sigmas = beta_sigmas(sigmas, num_inference_steps)

    timesteps = sigmas * cfg.num_train_timesteps
    if cfg.invert_sigmas:
        sigmas = 1.0 - sigmas
        timesteps = sigmas * cfg.num_train_timesteps
        sigmas = np.concatenate([sigmas, [1.0]])
    else:
        sigmas = np.concatenate([sigmas, [0.0]])
    return timesteps.astype(np.float32), sigmas.astype(np.float32)


def euler_step(x: Tensor, model_output: Tensor, sigma: float,
               sigma_next: float, *, stochastic: bool = False,
               noise: Optional[Tensor] = None,
               generator: Optional[torch.Generator] = None) -> Tensor:
    """One flow-match Euler update in float32, returned in x's dtype.

    Deterministic: x + (sigma_next - sigma) * v. Stochastic: renoise to
    the next level through the x0 prediction, with ``noise`` (x-shaped
    standard normal) or a draw from ``generator`` on the CPU."""
    x32 = x.float()
    v = model_output.float()
    sigma, sigma_next = np.float32(sigma), np.float32(sigma_next)
    if stochastic:
        if noise is None:
            noise = torch.randn(tuple(x.shape), generator=generator)
        noise = noise.to(device=x.device, dtype=torch.float32)
        x0_pred = x32 + float(np.float32(1.0) - sigma) * v
        out = float(sigma_next) * noise + float(
            np.float32(1.0) - sigma_next) * x0_pred
    else:
        out = x32 + float(sigma_next - sigma) * v
    return out.to(x.dtype)


def linear_sigmas(num_steps: int) -> np.ndarray:
    """linspace(0, 1, steps + 1) in float32."""
    return np.linspace(0.0, 1.0, num_steps + 1, dtype=np.float32)
