"""ODE / SDE sampler CLI flag groups and the sampler keyword arguments
built from them.

The port's own copy of fitv2_tpu/utils/eval_args.py (plain argparse).
"""

from __future__ import annotations

import argparse
from typing import Any, Dict


def none_or_str(value):
    return None if value == 'None' else value


def parse_sde_args(parser: argparse.ArgumentParser) -> None:
    group = parser.add_argument_group('SDE arguments')
    group.add_argument('--sde-sampling-method', type=str, default='Euler',
                       choices=['Euler', 'Heun'])
    group.add_argument('--diffusion-form', type=str, default='sigma',
                       choices=['constant', 'SBDM', 'sigma', 'linear',
                                'decreasing', 'increasing-decreasing'])
    group.add_argument('--diffusion-norm', type=float, default=1.0)
    group.add_argument('--last-step', type=none_or_str, default='Mean',
                       choices=[None, 'Mean', 'Tweedie', 'Euler'])
    group.add_argument('--last-step-size', type=float, default=0.04)


def parse_ode_args(parser: argparse.ArgumentParser) -> None:
    group = parser.add_argument_group('ODE arguments')
    group.add_argument('--ode-sampling-method', type=str, default='dopri5',
                       help='dopri5 (adaptive) | euler | heun')
    group.add_argument('--atol', type=float, default=1e-6)
    group.add_argument('--rtol', type=float, default=1e-3)
    group.add_argument('--reverse', action='store_true')
    group.add_argument('--likelihood', action='store_true')


def sde_kwargs_from_args(args) -> Dict[str, Any]:
    return dict(sampling_method=args.sde_sampling_method,
                diffusion_form=args.diffusion_form,
                diffusion_norm=args.diffusion_norm,
                last_step=args.last_step,
                last_step_size=args.last_step_size)


def ode_kwargs_from_args(args) -> Dict[str, Any]:
    return dict(sampling_method=args.ode_sampling_method,
                atol=args.atol, rtol=args.rtol, reverse=args.reverse)
