from fitv2_tpu_torch.flow.path import GVPCPlan, ICPlan, VPCPlan, expand_t_like_x
from fitv2_tpu_torch.flow.samplers import (
    cfg_model_fn, euler_ladder, euler_sample, euler_sample_extrapolated)
from fitv2_tpu_torch.flow.transport import (
    ModelType, PathType, SNRType, Transport, WeightType, create_transport,
    masked_loss_ratio, mean_flat)

__all__ = ['GVPCPlan', 'ICPlan', 'ModelType', 'PathType', 'SNRType',
           'Transport', 'VPCPlan', 'WeightType', 'cfg_model_fn',
           'create_transport', 'euler_ladder', 'euler_sample',
           'euler_sample_extrapolated', 'expand_t_like_x',
           'masked_loss_ratio', 'mean_flat']
