"""ImageNet VAE-latent shard dataset and a prefetching host loader.

Counterpart of fitv2_tpu/data/latent_dataset.py, with the same shard
layout, draws and batches:

- one safetensors file per image, with ``feature`` (2, h, w, 16) (the
  unflipped and flipped latents), ``grid`` (2, N), ``size`` (2,) and
  ``label`` (); in the bucket directories ``from_16_to_{L}``,
  ``greater_than_{L}_resize`` and ``greater_than_{L}_crop``;
- a resize-or-crop source choice and the flip, drawn per sample from a
  PCG64 stream keyed by (seed, global batch index, j), so a resumed run
  replays the uninterrupted run's draws;
- feature, grid and mask zero-padded to ``target_len``;
- the resumable index order of ``data.sampler``.

Batches are numpy dicts (feature, grid, mask, label, size). The loader's
backend is chosen explicitly: ``'native'`` (the C++ loader,
``data.native_loader``) or ``'python'`` (a thread pool over
``IN1kLatentDataset.get``); both give identical batches.
"""

from __future__ import annotations

import concurrent.futures as futures
import os
import os.path as osp
import queue
import threading
from typing import Dict, Iterator, List, Sequence

import numpy as np

from fitv2_tpu_torch.data import safetensors_np
from fitv2_tpu_torch.data.sampler import (
    batched, get_train_sampler, shard_indices)

BACKENDS = ('native', 'python')


class IN1kLatentDataset:
    """File discovery and one padded sample."""

    def __init__(self, root_dir: str, target_len: int = 256,
                 random: str = 'random', flip_prob: float = 0.5):
        self.root_dir = root_dir
        self.target_len = target_len
        self.random = random
        self.flip_prob = flip_prob
        d1 = osp.join(root_dir, f'from_16_to_{target_len}')
        d2 = osp.join(root_dir, f'greater_than_{target_len}_resize')
        d3 = osp.join(root_dir, f'greater_than_{target_len}_crop')
        files_1 = set(os.listdir(d1)) if osp.isdir(d1) else set()
        files_2 = set(os.listdir(d2)) if osp.isdir(d2) else set()
        files_3 = set(os.listdir(d3)) if osp.isdir(d3) else set()
        self.files: List[List[str]] = []
        self.files += [[osp.join(d1, f)] for f in sorted(files_1)]
        self.files += [[osp.join(d2, f)] for f in sorted(files_2 - files_3)]
        self.files += [[osp.join(d2, f), osp.join(d3, f)]
                       for f in sorted(files_3)]
        if not self.files:
            raise FileNotFoundError(
                f'no latent shards under {root_dir} for target_len='
                f'{target_len}')

    def __len__(self) -> int:
        return len(self.files)

    def pick(self, idx: int, rng: np.random.Generator):
        """The (path, flip) draws of sample ``idx``: the source first, then
        the flip, from the sample's own stream."""
        choices = self.files[idx]
        if self.random == 'random':
            path = choices[int(rng.integers(len(choices)))]
        elif self.random == 'resize':
            path = choices[0]
        else:  # 'crop'
            path = choices[-1]
        return path, int(rng.random() < self.flip_prob)

    def get(self, idx: int, rng: np.random.Generator
            ) -> Dict[str, np.ndarray]:
        path, flip = self.pick(idx, rng)
        data = safetensors_np.load_file(path)
        L = self.target_len
        n = data['grid'].shape[-1]
        feat_src = data['feature'][flip]  # (h, w, C)
        feature = np.zeros((L, feat_src.shape[-1]), np.float32)
        feature[:n] = feat_src.reshape(-1, feat_src.shape[-1])
        grid = np.zeros((2, L), np.int32)
        grid[:, :n] = data['grid']
        mask = np.zeros((L,), np.float32)
        mask[:n] = 1.0
        return dict(feature=feature, grid=grid, mask=mask,
                    label=np.asarray(data['label'], np.int32).reshape(()),
                    size=np.asarray(data['size'], np.int32).reshape(1, 2))


def _collate(samples: Sequence[Dict[str, np.ndarray]]
             ) -> Dict[str, np.ndarray]:
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


class PrefetchLoader:
    """Batches of the index stream, assembled ahead on a producer thread.

    ``backend``: 'native' (the C++ loader; a build failure raises) or
    'python'. ``batch_offset`` is the global index of the first batch
    (the resume step) and ``row_offset`` that of this process's first row
    in each global batch: together they key the per-sample draws, so a
    process's rows are those rows of the one-process batch."""

    def __init__(self, dataset: IN1kLatentDataset, index_stream: np.ndarray,
                 batch_size: int, num_workers: int = 8,
                 prefetch_batches: int = 4, seed: int = 0,
                 backend: str = 'native', batch_offset: int = 0,
                 row_offset: int = 0):
        if backend not in BACKENDS:
            raise ValueError(f'backend {backend!r}: one of {BACKENDS}')
        self.dataset = dataset
        self.index_stream = index_stream
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch_batches
        self.seed = seed
        self.backend = backend
        self.batch_offset = batch_offset
        self.row_offset = row_offset
        if backend == 'native':
            from fitv2_tpu_torch.data import native_loader
            native_loader.load_library()  # build now: a failure raises here

    def _rngs(self, bi: int, count: int) -> List[np.random.Generator]:
        return [np.random.Generator(np.random.PCG64(
            (self.seed, self.batch_offset + bi, self.row_offset + j)))
            for j in range(count)]

    def _batch(self, bi: int, idxs, pool) -> Dict[str, np.ndarray]:
        rngs = self._rngs(bi, len(idxs))
        if self.backend == 'python':
            return _collate(list(pool.map(lambda a: self.dataset.get(*a),
                                          zip(idxs, rngs))))
        from fitv2_tpu_torch.data import native_loader
        paths, flips = zip(*(self.dataset.pick(i, r)
                             for i, r in zip(idxs, rngs)))
        return native_loader.load_batch(paths, flips,
                                        self.dataset.target_len,
                                        num_threads=self.num_workers)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            try:
                with futures.ThreadPoolExecutor(self.num_workers) as pool:
                    for bi, idxs in enumerate(batched(self.index_stream,
                                                      self.batch_size)):
                        if stop.is_set():
                            return
                        q.put(self._batch(bi, idxs, pool))
                q.put(None)
            except Exception as e:  # handed to the consumer, re-raised
                q.put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            while t.is_alive():  # unblock a producer waiting on a full queue
                try:
                    q.get_nowait()
                except queue.Empty:
                    t.join(timeout=0.05)


class INLatentLoader:
    """The reference API's loader over a shard directory."""

    def __init__(self, data_path: str, target_len: int = 256,
                 random: str = 'random', batch_size: int = 32,
                 num_workers: int = 8, backend: str = 'native'):
        self.train_dataset = IN1kLatentDataset(data_path, target_len, random)
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.backend = backend

    def train_len(self) -> int:
        return len(self.train_dataset)

    def train_dataloader(self, global_batch_size: int, max_steps: int,
                         resume_step: int, seed: int = 42,
                         process_index: int = 0, process_count: int = 1
                         ) -> PrefetchLoader:
        """This process's loader over the resumable global stream."""
        stream = get_train_sampler(len(self.train_dataset), global_batch_size,
                                   max_steps, resume_step, seed)
        local = shard_indices(stream, global_batch_size, process_index,
                              process_count)
        per = global_batch_size // process_count
        return PrefetchLoader(self.train_dataset, local, per,
                              self.num_workers, seed=seed,
                              backend=self.backend, batch_offset=resume_step,
                              row_offset=process_index * per)


def make_synthetic_latent_shards(root_dir: str, n: int = 16,
                                 target_len: int = 256, n_classes: int = 1000,
                                 seed: int = 0, square: bool = False) -> None:
    """Write synthetic shards in the reference layout, the same files as
    the JAX package's function for the same arguments. ``square`` writes
    full max-side square grids only (no padding)."""
    rng = np.random.Generator(np.random.PCG64(seed))
    d1 = osp.join(root_dir, f'from_16_to_{target_len}')
    os.makedirs(d1, exist_ok=True)
    max_side = int(np.sqrt(target_len))
    for i in range(n):
        if square:
            h = w = max_side
        else:
            h = int(rng.integers(2, max_side + 1))
            w = int(rng.integers(2, max_side + 1))
        gw, gh = np.meshgrid(np.arange(w), np.arange(h))
        grid = np.stack([gw.reshape(-1), gh.reshape(-1)], 0).astype(np.int32)
        safetensors_np.save_file({
            'feature': rng.standard_normal((2, h, w, 16)).astype(np.float32),
            'grid': grid,
            'size': np.array([h, w], np.int32),
            'label': np.array(int(rng.integers(n_classes)), np.int32),
        }, osp.join(d1, f'{i:06d}.safetensors'))
