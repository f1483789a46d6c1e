from fitv2_tpu_torch.sample.buckets import STANDARD_BUCKETS, BucketedSampler
from fitv2_tpu_torch.sample.pipeline import (
    INTERPOLATION_MODES, SamplingConfig, apply_rope_interpolation,
    build_sampler, generate_fid_samples, save_npz)

__all__ = ['STANDARD_BUCKETS', 'BucketedSampler', 'INTERPOLATION_MODES',
           'SamplingConfig', 'apply_rope_interpolation', 'build_sampler',
           'generate_fid_samples', 'save_npz']
