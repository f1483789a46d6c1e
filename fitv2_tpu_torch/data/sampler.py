"""Deterministic, resumable index streams for training.

The port's own copy of fitv2_tpu/data/sampler.py (pure numpy): per-epoch
seeded PCG64 permutations concatenated until ``max_steps *
global_batch_size`` indices exist, then sliced at the resume step, so a run
resumed at step K reads exactly the indices the uninterrupted run read
from step K on. ``shard_indices`` slices each global batch per process.
"""

from __future__ import annotations

from typing import Iterator, List

import numpy as np


def get_train_sampler(dataset_len: int, global_batch_size: int,
                      max_steps: int, resume_step: int,
                      seed: int = 42) -> np.ndarray:
    """Global index stream of len (max_steps - resume_step)*global_batch."""
    total = max_steps * global_batch_size
    out = np.empty((total,), np.int64)
    fill, epoch = 0, 0
    while fill < total:
        rng = np.random.Generator(np.random.PCG64(seed + epoch))
        perm = rng.permutation(dataset_len)
        take = min(total - fill, dataset_len)
        out[fill:fill + take] = perm[:take]
        fill += take
        epoch += 1
    return out[resume_step * global_batch_size:]


def shard_indices(indices: np.ndarray, global_batch_size: int,
                  process_index: int, process_count: int) -> np.ndarray:
    """This process's slice of each global batch (contiguous split)."""
    assert global_batch_size % process_count == 0
    per = global_batch_size // process_count
    steps = len(indices) // global_batch_size
    view = indices[:steps * global_batch_size].reshape(
        steps, process_count, per)
    return view[:, process_index, :].reshape(-1)


def batched(indices: np.ndarray, batch_size: int) -> Iterator[List[int]]:
    n = len(indices) // batch_size
    for i in range(n):
        yield indices[i * batch_size:(i + 1) * batch_size].tolist()


def infinite_sampler(dataset_len: int, process_index: int = 0,
                     process_count: int = 1, shuffle: bool = True,
                     seed: int = 0, window_size: float = 0.5
                     ) -> Iterator[int]:
    """Endless per-process index stream with windowed reshuffling.

    Equivalent of the reference's dnnlib ``InfiniteSampler`` (its GAN and
    CIFAR loops): a fixed permutation is walked round-robin across
    processes forever; at each visit the current index is swapped with a
    random one inside a sliding window of ``window_size * dataset_len``,
    giving cheap continuous shuffling without epoch boundaries.
    Deterministic per (seed, process).
    """
    assert dataset_len > 0 and 0 <= window_size <= 1
    order = np.arange(dataset_len)
    window = 0
    if shuffle:
        rng = np.random.Generator(np.random.PCG64(seed))
        rng.shuffle(order)
        window = int(np.rint(dataset_len * window_size))
    idx = 0
    while True:
        i = idx % dataset_len
        if idx % process_count == process_index:
            yield int(order[i])
        if window >= 2:
            j = (i - rng.integers(window)) % dataset_len
            order[i], order[j] = order[j], order[i]
        idx += 1
