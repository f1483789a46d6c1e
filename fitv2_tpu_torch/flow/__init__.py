from fitv2_tpu_torch.flow.path import GVPCPlan, ICPlan, VPCPlan, expand_t_like_x
from fitv2_tpu_torch.flow.samplers import (
    ADAPTIVE_TABLEAUS, Sampler, cfg_model_fn, check_tableau, euler_ladder,
    euler_sample, euler_sample_extrapolated, ode_adaptive, ode_dopri5,
    ode_euler, ode_heun, ode_midpoint, ode_rk4, sde_sample)
from fitv2_tpu_torch.flow.transport import (
    ModelType, PathType, SNRType, Transport, WeightType, create_transport,
    masked_loss_ratio, mean_flat)

__all__ = ['ADAPTIVE_TABLEAUS', 'GVPCPlan', 'ICPlan', 'ModelType',
           'PathType', 'SNRType', 'Sampler', 'Transport', 'VPCPlan',
           'WeightType', 'cfg_model_fn', 'check_tableau', 'create_transport',
           'euler_ladder', 'euler_sample', 'euler_sample_extrapolated',
           'expand_t_like_x', 'masked_loss_ratio', 'mean_flat',
           'ode_adaptive', 'ode_dopri5', 'ode_euler', 'ode_heun',
           'ode_midpoint', 'ode_rk4', 'sde_sample']
