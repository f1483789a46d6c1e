from fitv2_tpu_torch.sample.pipeline import (
    SamplingConfig, build_sampler, generate_fid_samples, save_npz)

__all__ = ['SamplingConfig', 'build_sampler', 'generate_fid_samples',
           'save_npz']
