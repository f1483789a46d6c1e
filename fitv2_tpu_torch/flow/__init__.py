from fitv2_tpu_torch.flow.samplers import (
    cfg_model_fn, euler_ladder, euler_sample, euler_sample_extrapolated)

__all__ = ['cfg_model_fn', 'euler_ladder', 'euler_sample',
           'euler_sample_extrapolated']
