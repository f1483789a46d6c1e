"""Learning-rate schedules: ``step -> lr`` callables.

Counterpart of fitv2_tpu/train/lr_scheduler.py (the diffusers-style
``get_scheduler`` names: constant, constant_with_warmup, linear, cosine,
cosine_with_restarts, polynomial, piecewise_constant). Each schedule
computes in float32 with numpy, as the JAX schedules compute in jnp
float32, and returns the value as a Python float. The optimizer calls it
with the count of updates applied so far, so the first update takes
``lr(0)``.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np

Schedule = Callable[[int], float]
_f32 = np.float32


def _warm(s, num_warmup_steps):
    return s / _f32(max(1.0, num_warmup_steps))


def constant_schedule(base_lr: float) -> Schedule:
    return lambda step: float(_f32(base_lr))


def constant_with_warmup(base_lr: float, num_warmup_steps: int) -> Schedule:
    def fn(step):
        warm = np.clip(_warm(_f32(step), num_warmup_steps), _f32(0), _f32(1))
        return float(_f32(base_lr) * warm)
    return fn


def linear_schedule(base_lr: float, num_warmup_steps: int,
                    num_training_steps: int) -> Schedule:
    def fn(step):
        s = _f32(step)
        if s < num_warmup_steps:
            value = _warm(s, num_warmup_steps)
        else:
            value = (_f32(num_training_steps) - s) / _f32(
                max(1.0, num_training_steps - num_warmup_steps))
        return float(_f32(base_lr) * np.clip(value, _f32(0), _f32(1)))
    return fn


def _progress(s, num_warmup_steps, num_training_steps):
    progress = (s - _f32(num_warmup_steps)) / _f32(
        max(1.0, num_training_steps - num_warmup_steps))
    return np.clip(progress, _f32(0), _f32(1))


def cosine_schedule(base_lr: float, num_warmup_steps: int,
                    num_training_steps: int, num_cycles: float = 0.5
                    ) -> Schedule:
    def fn(step):
        s = _f32(step)
        if s < num_warmup_steps:
            return float(_f32(base_lr) * _warm(s, num_warmup_steps))
        progress = _progress(s, num_warmup_steps, num_training_steps)
        cos = _f32(0.5) * (_f32(1) + np.cos(
            _f32(math.pi * num_cycles * 2.0) * progress))
        return float(_f32(base_lr) * np.maximum(_f32(0), cos))
    return fn


def cosine_with_restarts(base_lr: float, num_warmup_steps: int,
                         num_training_steps: int, num_cycles: int = 1
                         ) -> Schedule:
    def fn(step):
        s = _f32(step)
        if s < num_warmup_steps:
            return float(_f32(base_lr) * _warm(s, num_warmup_steps))
        progress = _progress(s, num_warmup_steps, num_training_steps)
        if progress >= 1.0:
            return 0.0
        cyc = (progress * _f32(num_cycles)) % _f32(1)
        cos = _f32(0.5) * (_f32(1) + np.cos(_f32(math.pi) * cyc))
        return float(_f32(base_lr) * np.maximum(_f32(0), cos))
    return fn


def polynomial_schedule(base_lr: float, num_warmup_steps: int,
                        num_training_steps: int, lr_end: float = 1e-7,
                        power: float = 1.0) -> Schedule:
    def fn(step):
        s = _f32(step)
        if s < num_warmup_steps:
            return float(_f32(base_lr) * s / _f32(max(1.0,
                                                      num_warmup_steps)))
        if s > num_training_steps:
            return float(_f32(lr_end))
        rem = np.clip((_f32(num_training_steps) - s) / _f32(
            max(1.0, num_training_steps - num_warmup_steps)),
            _f32(0), _f32(1))
        return float(_f32(base_lr - lr_end) * rem ** _f32(power)
                     + _f32(lr_end))
    return fn


def piecewise_constant(base_lr: float, step_rules: str) -> Schedule:
    """'1:100,0.1:200,0.01': each multiplier until its step, then the
    next; the last one after the last step."""
    parts = step_rules.split(',')
    bounds, values = [], []
    for p in parts[:-1]:
        mult, until = p.split(':')
        values.append(float(mult))
        bounds.append(int(until))
    values.append(float(parts[-1]))

    def fn(step):
        for bound, value in zip(bounds, values):
            if step < bound:
                return float(_f32(base_lr) * _f32(value))
        return float(_f32(base_lr) * _f32(values[-1]))
    return fn


def get_scheduler(name: str, base_lr: float,
                  num_warmup_steps: Optional[int] = None,
                  num_training_steps: Optional[int] = None,
                  num_cycles: float = 1, power: float = 1.0,
                  step_rules: Optional[str] = None) -> Schedule:
    """The reference API's factory (the JAX package's get_scheduler)."""
    name = name.lower()
    if name == 'constant':
        return constant_schedule(base_lr)
    if name == 'piecewise_constant':
        return piecewise_constant(base_lr, step_rules)
    if num_warmup_steps is None:
        raise ValueError(f'{name} requires num_warmup_steps')
    if name == 'constant_with_warmup':
        return constant_with_warmup(base_lr, num_warmup_steps)
    if num_training_steps is None:
        raise ValueError(f'{name} requires num_training_steps')
    if name == 'linear':
        return linear_schedule(base_lr, num_warmup_steps, num_training_steps)
    if name == 'cosine':
        return cosine_schedule(base_lr, num_warmup_steps, num_training_steps,
                               num_cycles=0.5 if num_cycles == 1
                               else num_cycles)
    if name == 'cosine_with_restarts':
        return cosine_with_restarts(base_lr, num_warmup_steps,
                                    num_training_steps, int(num_cycles))
    if name == 'polynomial':
        return polynomial_schedule(base_lr, num_warmup_steps,
                                   num_training_steps, power=power)
    raise ValueError(f'unknown scheduler {name}')
