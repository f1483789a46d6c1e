"""Importance-weighted timestep sampling for improved-DDPM training.

Counterpart of fitv2_tpu/sched/timestep_sampler.py, whose code is numpy
only and is kept here as it is there:

  - ``UniformSampler``: t ~ U{0..T-1}, unit importance weights;
  - ``LossSecondMomentResampler``: keeps the ``history_per_term`` most
    recent losses per timestep and, once every term is warmed up, samples
    t with p(t) proportional to sqrt(E[loss_t^2]) (mixed with a uniform
    floor ``uniform_prob``) and weights 1 / (T p[t]), which keeps the loss
    estimator unbiased.

Sampling is host-side batch construction driven by a numpy ``Generator``;
the loss history is a numpy ring buffer. The draws of t and their weights
go into the train step's batch as ``t`` and ``t_weight``, and its
``per_t_loss`` metric feeds ``update_with_all_losses``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


class ScheduleSampler:
    """Base: distribution over timesteps to reduce loss-estimator variance.

    ``sample`` draws (t, weights) where E_t[weights · loss_t] equals the
    uniform-expectation loss.
    """

    def weights(self) -> np.ndarray:
        raise NotImplementedError

    def sample(self, batch_size: int,
               rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
        w = np.asarray(self.weights(), np.float64)
        p = w / w.sum()
        t = rng.choice(len(p), size=(batch_size,), p=p)
        weights = 1.0 / (len(p) * p[t])
        return t.astype(np.int64), weights.astype(np.float32)

    def update_with_all_losses(self, ts: np.ndarray,
                               losses: np.ndarray) -> None:
        """No-op by default; resamplers record per-timestep losses."""


class UniformSampler(ScheduleSampler):
    """t uniform over the ladder."""

    def __init__(self, num_timesteps: int):
        self._w = np.ones((num_timesteps,), np.float64)

    def weights(self) -> np.ndarray:
        return self._w


class LossSecondMomentResampler(ScheduleSampler):
    """p(t) from the second moment of each timestep's recent losses."""

    def __init__(self, num_timesteps: int, history_per_term: int = 10,
                 uniform_prob: float = 0.001):
        self.num_timesteps = num_timesteps
        self.history_per_term = history_per_term
        self.uniform_prob = uniform_prob
        self._history = np.zeros((num_timesteps, history_per_term),
                                 np.float64)
        self._counts = np.zeros((num_timesteps,), np.int64)

    def _warmed_up(self) -> bool:
        return bool((self._counts == self.history_per_term).all())

    def weights(self) -> np.ndarray:
        if not self._warmed_up():
            return np.ones((self.num_timesteps,), np.float64)
        w = np.sqrt(np.mean(self._history ** 2, axis=-1))
        w /= w.sum()
        w *= 1.0 - self.uniform_prob
        w += self.uniform_prob / len(w)
        return w

    def update_with_all_losses(self, ts: np.ndarray,
                               losses: np.ndarray) -> None:
        for t, loss in zip(np.asarray(ts).reshape(-1),
                           np.asarray(losses, np.float64).reshape(-1)):
            t = int(t)
            if self._counts[t] == self.history_per_term:
                # ring shift: drop the oldest loss
                self._history[t, :-1] = self._history[t, 1:]
                self._history[t, -1] = loss
            else:
                self._history[t, self._counts[t]] = loss
                self._counts[t] += 1


def create_named_schedule_sampler(name: str,
                                  num_timesteps: int) -> ScheduleSampler:
    """'uniform' or 'loss-second-moment'."""
    if name == 'uniform':
        return UniformSampler(num_timesteps)
    if name == 'loss-second-moment':
        return LossSecondMomentResampler(num_timesteps)
    raise NotImplementedError(f'unknown schedule sampler: {name}')
