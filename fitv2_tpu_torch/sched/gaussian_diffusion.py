"""Gaussian diffusion (improved DDPM) for the FiTv1 epsilon-prediction path.

Counterpart of fitv2_tpu/sched/gaussian_diffusion.py: the beta schedules,
timestep respacing (``space_timesteps``, ``create_diffusion``), the
forward process, ``p_mean_variance``, the ancestral and DDIM loops and
the training losses (MSE plus the learned-range variational bound, with
the padded-token reweighting).

The coefficient ladders are numpy float64, built as in JAX and rounded
to float32 once, where JAX's ``_ext`` rounds them (``log(betas)`` is
taken in float64 before the rounding); the float32 ladders live on each
device they are gathered on. The loops are Python loops over the ladder.
``jax.random`` and torch streams never match, so every draw is either
given as a tensor or taken from a CPU ``torch.Generator``, and then moved
to the data's device: a seed gives the same numbers on any device.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Callable, Dict, Optional, Set

import numpy as np
import torch

Tensor = torch.Tensor
ModelFn = Callable[[Tensor, Tensor], Tensor]  # (x, t_int) -> model output


class ModelMeanType(enum.Enum):
    PREVIOUS_X = enum.auto()
    START_X = enum.auto()
    EPSILON = enum.auto()


class ModelVarType(enum.Enum):
    LEARNED = enum.auto()
    FIXED_SMALL = enum.auto()
    FIXED_LARGE = enum.auto()
    LEARNED_RANGE = enum.auto()


class LossType(enum.Enum):
    MSE = enum.auto()
    RESCALED_MSE = enum.auto()
    KL = enum.auto()
    RESCALED_KL = enum.auto()

    def is_vb(self):
        return self in (LossType.KL, LossType.RESCALED_KL)


def get_named_beta_schedule(name: str, num_steps: int) -> np.ndarray:
    """'linear' (scaled DDPM) and 'squaredcos_cap_v2' cosine schedules."""
    if name == 'linear':
        scale = 1000 / num_steps
        return np.linspace(scale * 0.0001, scale * 0.02, num_steps,
                           dtype=np.float64)
    if name in ('cosine', 'squaredcos_cap_v2'):
        def acb(t):
            return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2
        return np.array([min(1 - acb((i + 1) / num_steps) / acb(i / num_steps),
                             0.999) for i in range(num_steps)],
                        dtype=np.float64)
    raise NotImplementedError(f'unknown beta schedule: {name}')


def space_timesteps(num_timesteps: int, section_counts) -> Set[int]:
    """The timesteps a respaced ladder keeps: 'ddimN' takes N evenly
    strided steps; 'N', 'n1,n2,...' or a list spaces each of that many
    equal sections evenly."""
    if isinstance(section_counts, str):
        if section_counts.startswith('ddim'):
            desired = int(section_counts[len('ddim'):])
            for i in range(1, num_timesteps):
                if len(range(0, num_timesteps, i)) == desired:
                    return set(range(0, num_timesteps, i))
            raise ValueError(f'cannot create exactly {desired} steps with '
                             'an integer stride')
        section_counts = [int(x) for x in section_counts.split(',')]
    size_per = num_timesteps // len(section_counts)
    extra = num_timesteps % len(section_counts)
    start = 0
    all_steps = []
    for i, count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if size < count:
            raise ValueError(f'cannot divide section of {size} steps into '
                             f'{count}')
        stride = 1 if count <= 1 else (size - 1) / (count - 1)
        cur = 0.0
        for _ in range(count):
            all_steps.append(start + round(cur))
            cur += stride
        start += size
    return set(all_steps)


def normal_kl(mean1, logvar1, mean2, logvar2):
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + ((mean1 - mean2) ** 2) * torch.exp(-logvar2))


def approx_standard_normal_cdf(x):
    return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                   * (x + 0.044715 * x ** 3)))


def discretized_gaussian_log_likelihood(x, *, means, log_scales):
    """Log-likelihood of images discretized to the [-1, 1] 255-bin grid."""
    centered_x = x - means
    inv_stdv = torch.exp(-log_scales)
    cdf_plus = approx_standard_normal_cdf(inv_stdv * (centered_x + 1.0 / 255.0))
    cdf_min = approx_standard_normal_cdf(inv_stdv * (centered_x - 1.0 / 255.0))
    log_cdf_plus = torch.log(torch.clamp(cdf_plus, min=1e-12))
    log_one_minus_cdf_min = torch.log(torch.clamp(1.0 - cdf_min, min=1e-12))
    log_cdf_delta = torch.log(torch.clamp(cdf_plus - cdf_min, min=1e-12))
    return torch.where(x < -0.999, log_cdf_plus,
                       torch.where(x > 0.999, log_one_minus_cdf_min,
                                   log_cdf_delta))


def mean_flat(x: Tensor) -> Tensor:
    return x.mean(dim=tuple(range(1, x.dim())))


def _broadcast(v: Tensor, ndim: int) -> Tensor:
    return v.reshape(v.shape + (1,) * (ndim - 1))


@dataclasses.dataclass(frozen=True, eq=False)
class GaussianDiffusion:
    """Coefficient ladders and the sampling and training math.

    ``timestep_map`` is set when the ladder was respaced: the model is
    called with the original training timestep of each compact index
    (``_model_t``)."""
    betas: np.ndarray
    model_mean_type: ModelMeanType = ModelMeanType.EPSILON
    model_var_type: ModelVarType = ModelVarType.LEARNED_RANGE
    loss_type: LossType = LossType.MSE
    timestep_map: Optional[np.ndarray] = None
    original_num_steps: Optional[int] = None

    def __post_init__(self):
        betas = np.asarray(self.betas, np.float64)
        if not ((betas > 0).all() and (betas <= 1).all()):
            raise ValueError('betas must lie in (0, 1]')
        alphas = 1.0 - betas
        ac = np.cumprod(alphas)
        ac_prev = np.append(1.0, ac[:-1])
        ac_next = np.append(ac[1:], 0.0)
        post_var = betas * (1.0 - ac_prev) / (1.0 - ac)
        post_logvar = np.log(np.append(post_var[1], post_var[1:]))
        coef1 = betas * np.sqrt(ac_prev) / (1.0 - ac)
        coef2 = (1.0 - ac_prev) * np.sqrt(alphas) / (1.0 - ac)
        fixed_large = np.append(post_var[1], betas[1:])
        # every float64 ladder the math gathers, each as JAX computes it
        # before its float32 rounding
        ladders = {
            'alphas_cumprod': ac,
            'alphas_cumprod_prev': ac_prev,
            'alphas_cumprod_next': ac_next,
            'one_minus_alphas_cumprod': 1.0 - ac,
            'sqrt_alphas_cumprod': np.sqrt(ac),
            'sqrt_one_minus_alphas_cumprod': np.sqrt(1.0 - ac),
            'log_one_minus_alphas_cumprod': np.log(1.0 - ac),
            'sqrt_recip_alphas_cumprod': np.sqrt(1.0 / ac),
            'sqrt_recipm1_alphas_cumprod': np.sqrt(1.0 / ac - 1),
            'posterior_variance': post_var,
            'posterior_log_variance_clipped': post_logvar,
            'posterior_mean_coef1': coef1,
            'posterior_mean_coef2': coef2,
            'recip_posterior_mean_coef1': 1.0 / coef1,
            'posterior_mean_coef2_over_coef1': coef2 / coef1,
            'log_betas': np.log(betas),
            'fixed_large_variance': fixed_large,
            'fixed_large_log_variance': np.log(fixed_large),
        }
        object.__setattr__(self, 'num_timesteps', betas.shape[0])
        object.__setattr__(self, 'ladders64', ladders)
        object.__setattr__(self, '_on_device', {})

    def _ladder(self, name: str, device: torch.device) -> Tensor:
        key = (name, device)
        if key not in self._on_device:
            self._on_device[key] = torch.from_numpy(
                self.ladders64[name].astype(np.float32)).to(device)
        return self._on_device[key]

    def _ext(self, name: str, t: Tensor, ndim: int) -> Tensor:
        """The float32 ladder at integer t (B,), broadcast to rank ndim."""
        return _broadcast(self._ladder(name, t.device)[t], ndim)

    def _model_t(self, t: Tensor) -> Tensor:
        if self.timestep_map is None:
            return t
        key = ('timestep_map', t.device)
        if key not in self._on_device:
            self._on_device[key] = torch.from_numpy(
                np.asarray(self.timestep_map, np.int64)).to(t.device)
        return self._on_device[key][t]

    # -- forward process ------------------------------------------------------
    def q_mean_variance(self, x_start, t):
        n = x_start.dim()
        return (self._ext('sqrt_alphas_cumprod', t, n) * x_start,
                self._ext('one_minus_alphas_cumprod', t, n),
                self._ext('log_one_minus_alphas_cumprod', t, n))

    def q_sample(self, x_start, t, noise):
        n = x_start.dim()
        return (self._ext('sqrt_alphas_cumprod', t, n) * x_start
                + self._ext('sqrt_one_minus_alphas_cumprod', t, n) * noise)

    def q_posterior_mean_variance(self, x_start, x_t, t):
        n = x_t.dim()
        mean = (self._ext('posterior_mean_coef1', t, n) * x_start
                + self._ext('posterior_mean_coef2', t, n) * x_t)
        return (mean, self._ext('posterior_variance', t, n),
                self._ext('posterior_log_variance_clipped', t, n))

    # -- x0 / eps conversions -------------------------------------------------
    def _predict_xstart_from_eps(self, x_t, t, eps):
        n = x_t.dim()
        return (self._ext('sqrt_recip_alphas_cumprod', t, n) * x_t
                - self._ext('sqrt_recipm1_alphas_cumprod', t, n) * eps)

    def _predict_xstart_from_xprev(self, x_t, t, xprev):
        n = x_t.dim()
        return (self._ext('recip_posterior_mean_coef1', t, n) * xprev
                - self._ext('posterior_mean_coef2_over_coef1', t, n) * x_t)

    def _predict_eps_from_xstart(self, x_t, t, pred_xstart):
        n = x_t.dim()
        return ((self._ext('sqrt_recip_alphas_cumprod', t, n) * x_t
                 - pred_xstart)
                / self._ext('sqrt_recipm1_alphas_cumprod', t, n))

    # -- reverse process ------------------------------------------------------
    def p_mean_variance(self, model_fn: ModelFn, x, t, clip_denoised=True,
                        denoised_fn=None) -> Dict[str, Tensor]:
        """The reverse step's mean, variance, log-variance and x0 estimate
        at integer timesteps t (B,) of this ladder."""
        n = x.dim()
        model_output = model_fn(x, self._model_t(t))
        if self.model_var_type in (ModelVarType.LEARNED,
                                   ModelVarType.LEARNED_RANGE):
            if model_output.shape[-1] != 2 * x.shape[-1]:
                raise ValueError(f'learned-sigma model must output 2C '
                                 f'channels, got {tuple(model_output.shape)}')
            model_output, model_var_values = model_output.chunk(2, dim=-1)
            if self.model_var_type == ModelVarType.LEARNED:
                model_log_variance = model_var_values
            else:
                min_log = self._ext('posterior_log_variance_clipped', t, n)
                max_log = self._ext('log_betas', t, n)
                frac = (model_var_values + 1) / 2
                model_log_variance = frac * max_log + (1 - frac) * min_log
            model_variance = torch.exp(model_log_variance)
        elif self.model_var_type == ModelVarType.FIXED_LARGE:
            model_variance = self._ext('fixed_large_variance', t, n)
            model_log_variance = self._ext('fixed_large_log_variance', t, n)
        else:
            model_variance = self._ext('posterior_variance', t, n)
            model_log_variance = self._ext('posterior_log_variance_clipped',
                                           t, n)

        def process_xstart(xs):
            if denoised_fn is not None:
                xs = denoised_fn(xs)
            return torch.clamp(xs, -1, 1) if clip_denoised else xs

        if self.model_mean_type == ModelMeanType.PREVIOUS_X:
            pred_xstart = process_xstart(
                self._predict_xstart_from_xprev(x, t, model_output))
            model_mean = model_output
        else:
            if self.model_mean_type == ModelMeanType.START_X:
                pred_xstart = process_xstart(model_output)
            else:  # EPSILON
                pred_xstart = process_xstart(
                    self._predict_xstart_from_eps(x, t, model_output))
            model_mean, _, _ = self.q_posterior_mean_variance(pred_xstart, x,
                                                              t)
        return {'mean': model_mean, 'variance': model_variance,
                'log_variance': model_log_variance,
                'pred_xstart': pred_xstart}

    def p_sample(self, model_fn, x, t, noise, clip_denoised=True,
                 denoised_fn=None):
        """One ancestral step; ``noise`` is x-shaped standard normal."""
        out = self.p_mean_variance(model_fn, x, t, clip_denoised, denoised_fn)
        nonzero = _broadcast((t != 0).to(x.dtype), x.dim())
        sample = out['mean'] + nonzero * torch.exp(
            0.5 * out['log_variance']) * noise
        return {'sample': sample, 'pred_xstart': out['pred_xstart']}

    def ddim_sample(self, model_fn, x, t, noise=None, clip_denoised=True,
                    denoised_fn=None, eta=0.0):
        """One DDIM step. ``noise`` is needed when eta > 0; at eta 0 the
        step is deterministic and it may be None."""
        n = x.dim()
        out = self.p_mean_variance(model_fn, x, t, clip_denoised, denoised_fn)
        eps = self._predict_eps_from_xstart(x, t, out['pred_xstart'])
        alpha_bar = self._ext('alphas_cumprod', t, n)
        alpha_bar_prev = self._ext('alphas_cumprod_prev', t, n)
        sigma = (eta * torch.sqrt((1 - alpha_bar_prev) / (1 - alpha_bar))
                 * torch.sqrt(1 - alpha_bar / alpha_bar_prev))
        sample = (out['pred_xstart'] * torch.sqrt(alpha_bar_prev)
                  + torch.sqrt(1 - alpha_bar_prev - sigma ** 2) * eps)
        if eta != 0.0:
            nonzero = _broadcast((t != 0).to(x.dtype), n)
            sample = sample + nonzero * sigma * noise
        return {'sample': sample, 'pred_xstart': out['pred_xstart']}

    def _loop(self, step, shape, noise, step_noise, generator, device,
              draws_noise):
        """Run ``step(x, t_vec, noise_i)`` over t = T-1 .. 0 from ``noise``
        (else a draw of ``shape`` from ``generator``). The per-step noise is
        ``step_noise`` (T, *shape), else one draw of that shape from
        ``generator`` after the initial one; ``draws_noise`` False draws
        none (DDIM at eta 0)."""
        if noise is None:
            noise = torch.randn(tuple(shape), generator=generator)
        device = noise.device if device is None else torch.device(device)
        x = noise.to(device=device, dtype=torch.float32)
        T = self.num_timesteps
        if draws_noise and step_noise is None:
            step_noise = torch.randn((T,) + tuple(shape), generator=generator)
        if step_noise is not None:
            if tuple(step_noise.shape) != (T,) + tuple(shape):
                raise ValueError(f'step_noise must be {(T,) + tuple(shape)}, '
                                 f'got {tuple(step_noise.shape)}')
            step_noise = step_noise.to(device=device, dtype=torch.float32)
        for i in range(T):
            t_vec = torch.full((shape[0],), T - 1 - i, dtype=torch.int64,
                               device=device)
            x = step(x, t_vec, None if step_noise is None else step_noise[i])
        return x

    def p_sample_loop(self, model_fn, shape, noise=None, clip_denoised=True,
                      denoised_fn=None, step_noise=None, generator=None,
                      device=None) -> Tensor:
        """Ancestral sampling over the whole ladder, from ``noise`` (or a
        draw from ``generator``), on ``device`` (default: noise's)."""
        def step(x, t, eps):
            return self.p_sample(model_fn, x, t, eps, clip_denoised,
                                 denoised_fn)['sample']
        return self._loop(step, shape, noise, step_noise, generator, device,
                          True)

    def ddim_sample_loop(self, model_fn, shape, noise=None,
                         clip_denoised=True, denoised_fn=None, eta=0.0,
                         step_noise=None, generator=None,
                         device=None) -> Tensor:
        """DDIM over the whole ladder; per-step noise only when eta > 0."""
        def step(x, t, eps):
            return self.ddim_sample(model_fn, x, t, eps, clip_denoised,
                                    denoised_fn, eta)['sample']
        return self._loop(step, shape, noise, step_noise, generator, device,
                          eta != 0.0)

    # -- training -------------------------------------------------------------
    def _vb_terms_bpd(self, model_fn, x_start, x_t, t, clip_denoised=True):
        true_mean, _, true_logvar = self.q_posterior_mean_variance(
            x_start, x_t, t)
        out = self.p_mean_variance(model_fn, x_t, t, clip_denoised)
        kl = normal_kl(true_mean, true_logvar, out['mean'],
                       out['log_variance'])
        kl = mean_flat(kl) / math.log(2.0)
        decoder_nll = -discretized_gaussian_log_likelihood(
            x_start, means=out['mean'], log_scales=0.5 * out['log_variance'])
        decoder_nll = mean_flat(decoder_nll) / math.log(2.0)
        return {'output': torch.where(t == 0, decoder_nll, kl),
                'pred_xstart': out['pred_xstart']}

    def training_losses(self, model_fn: ModelFn, x_start, t,
                        mask: Optional[Tensor] = None,
                        noise: Optional[Tensor] = None,
                        generator: Optional[torch.Generator] = None
                        ) -> Dict[str, Tensor]:
        """Losses (B,) at integer timesteps t (B,): 'loss', and for the MSE
        types 'mse' (masked, scaled by N / nnz for a (B, N) mask) and, for a
        learned variance, 'vb' (the bound on the variance channels with the
        mean's gradient stopped). ``noise`` is drawn from ``generator`` on
        the CPU unless given."""
        if noise is None:
            noise = torch.randn(tuple(x_start.shape), generator=generator)
        noise = noise.to(device=x_start.device, dtype=x_start.dtype)
        x_t = self.q_sample(x_start, t, noise)
        if mask is not None:
            mask_b = mask[..., None].to(x_start.dtype)
            ratio = mask.shape[-1] / torch.count_nonzero(
                mask, dim=-1).float()
        else:
            mask_b, ratio = 1.0, 1.0

        terms: Dict[str, Tensor] = {}
        if self.loss_type.is_vb():
            terms['loss'] = self._vb_terms_bpd(model_fn, x_start, x_t, t,
                                               clip_denoised=False)['output']
            if self.loss_type == LossType.RESCALED_KL:
                terms['loss'] = terms['loss'] * self.num_timesteps
            return terms
        model_output = model_fn(x_t, self._model_t(t))
        if self.model_var_type in (ModelVarType.LEARNED,
                                   ModelVarType.LEARNED_RANGE):
            model_output, model_var_values = model_output.chunk(2, dim=-1)
            frozen_out = torch.cat([model_output.detach(), model_var_values],
                                   dim=-1)
            terms['vb'] = self._vb_terms_bpd(
                lambda *a: frozen_out, x_start, x_t, t,
                clip_denoised=False)['output']
            if self.loss_type == LossType.RESCALED_MSE:
                terms['vb'] = terms['vb'] * self.num_timesteps / 1000.0
        if self.model_mean_type == ModelMeanType.PREVIOUS_X:
            target = self.q_posterior_mean_variance(x_start, x_t, t)[0]
        elif self.model_mean_type == ModelMeanType.START_X:
            target = x_start
        else:
            target = noise
        terms['mse'] = mean_flat(
            ((target - model_output) * mask_b) ** 2) * ratio
        terms['loss'] = terms['mse'] + terms['vb'] if 'vb' in terms \
            else terms['mse']
        return terms


def create_diffusion(timestep_respacing: str = '',
                     noise_schedule: str = 'linear',
                     use_kl: bool = False,
                     sigma_small: bool = False,
                     predict_xstart: bool = False,
                     learn_sigma: bool = True,
                     rescale_learned_sigmas: bool = False,
                     diffusion_steps: int = 1000) -> GaussianDiffusion:
    """The improved-diffusion factory with the reference defaults; a
    respaced ladder recomputes its betas from the kept steps'
    cumulative alphas."""
    betas = get_named_beta_schedule(noise_schedule, diffusion_steps)
    if use_kl:
        loss_type = LossType.RESCALED_KL
    elif rescale_learned_sigmas:
        loss_type = LossType.RESCALED_MSE
    else:
        loss_type = LossType.MSE
    if not timestep_respacing:
        timestep_respacing = [diffusion_steps]
    use_steps = sorted(space_timesteps(diffusion_steps, timestep_respacing))
    if len(use_steps) == diffusion_steps:
        timestep_map = None
        new_betas = betas
    else:
        ac = np.cumprod(1.0 - betas)
        last = 1.0
        new_betas, tmap = [], []
        for i, a in enumerate(ac):
            if i in use_steps:
                new_betas.append(1 - a / last)
                last = a
                tmap.append(i)
        new_betas = np.array(new_betas)
        timestep_map = np.array(tmap, np.int32)
    if learn_sigma:
        var_type = ModelVarType.LEARNED_RANGE
    else:
        var_type = (ModelVarType.FIXED_SMALL if sigma_small
                    else ModelVarType.FIXED_LARGE)
    return GaussianDiffusion(
        betas=new_betas,
        model_mean_type=(ModelMeanType.START_X if predict_xstart
                         else ModelMeanType.EPSILON),
        model_var_type=var_type, loss_type=loss_type,
        timestep_map=timestep_map, original_num_steps=diffusion_steps)
