"""Training data: latent shards, the resumable sampler and the loaders."""

from fitv2_tpu_torch.data.latent_dataset import (
    IN1kLatentDataset, INLatentLoader, PrefetchLoader,
    make_synthetic_latent_shards)
from fitv2_tpu_torch.data.sampler import (
    batched, get_train_sampler, infinite_sampler, shard_indices)

__all__ = ['IN1kLatentDataset', 'INLatentLoader', 'PrefetchLoader',
           'batched', 'get_train_sampler', 'infinite_sampler',
           'make_synthetic_latent_shards', 'shard_indices']
