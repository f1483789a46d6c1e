"""Diffusion and flow schedulers: flow-match sigma ladders and improved
DDPM (FiTv1), counterpart of fitv2_tpu/sched."""

from fitv2_tpu_torch.sched.flow_match import (
    FlowMatchEulerConfig, calculate_shift, euler_step, linear_sigmas,
    set_timesteps, time_shift)
from fitv2_tpu_torch.sched.gaussian_diffusion import (
    GaussianDiffusion, LossType, ModelMeanType, ModelVarType,
    create_diffusion, get_named_beta_schedule, space_timesteps)
from fitv2_tpu_torch.sched.timestep_sampler import (
    LossSecondMomentResampler, ScheduleSampler, UniformSampler,
    create_named_schedule_sampler)

__all__ = [
    'FlowMatchEulerConfig', 'calculate_shift', 'euler_step', 'linear_sigmas',
    'set_timesteps', 'time_shift',
    'GaussianDiffusion', 'LossType', 'ModelMeanType', 'ModelVarType',
    'create_diffusion', 'get_named_beta_schedule', 'space_timesteps',
    'LossSecondMomentResampler', 'ScheduleSampler', 'UniformSampler',
    'create_named_schedule_sampler',
]
