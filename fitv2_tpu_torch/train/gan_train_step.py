"""GAN-guided training: a generator step with an adversarial term and a
PatchGAN discriminator step.

Counterpart of fitv2_tpu/train/gan_train_step.py on the port's train-step
machinery. The generator is any model ``make_step`` trains (masters,
compute copy, clip, AdamW, EMA in one ``TrainState``); the discriminator
is a module that holds its own parameters and BatchNorm statistics, with
its optimizer, in a ``DiscState``.

- ``gen_step``: the task's base loss plus ``disc_weight * factor *
  -mean(D(fake))``, factor ``disc_factor`` once the generator's step
  reaches ``disc_start``. D normalises with the fake batch's statistics
  and its running statistics stay as they were (JAX applies it with
  ``mutable=['batch_stats']`` and throws the update away); no gradient
  reaches D's parameters.
- ``disc_step``: the hinge (or vanilla) loss of D on the real batch, then
  on the detached fake batch, times the factor at ``global_step``; the
  running statistics move twice, by the real batch and then by the fake
  one; then D's optimizer steps (JAX's ``optax.adam(lr, b1=0.5, b2=0.9)``
  is ``disc_adam``: the port's optax-faithful AdamW at weight decay 0).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Optional, Set, Tuple

import torch
from torch import nn

from fitv2_tpu_torch.losses.perceptual import (
    LPIPSWithDiscriminator2D, hinge_d_loss, vanilla_d_loss)
from fitv2_tpu_torch.parallel.mesh import process_count
from fitv2_tpu_torch.train.train_step import AdamW, TrainState, make_step

Tensor = torch.Tensor


@dataclasses.dataclass
class DiscState:
    """step: discriminator updates taken; disc: the module (parameters and
    running statistics); optimizer: over ``disc.parameters()``."""
    step: int
    disc: nn.Module
    optimizer: torch.optim.Optimizer


def disc_adam(params, lr: float = 1e-4) -> AdamW:
    """``optax.adam(lr, b1=0.5, b2=0.9)``."""
    return AdamW(params, lr, betas=(0.5, 0.9), eps=1e-8, weight_decay=0.0)


def create_disc_state(disc: nn.Module,
                      optimizer_fn: Callable = disc_adam) -> DiscState:
    """A fresh ``DiscState`` over an initialised ``disc``;
    ``optimizer_fn(parameters)`` builds its optimizer."""
    return DiscState(0, disc, optimizer_fn(list(disc.parameters())))


@contextlib.contextmanager
def _frozen(module: nn.Module):
    """No gradient into ``module``'s parameters inside the block."""
    flags = [(p, p.requires_grad) for p in module.parameters()]
    for p, _ in flags:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p, flag in flags:
            p.requires_grad_(flag)


def make_gan_steps(generator_loss_fn: Callable, model: nn.Module,
                   loss_cfg: Optional[LPIPSWithDiscriminator2D] = None,
                   max_grad_norm: float = 1.0, ema_decay: float = 0.9999,
                   required: Optional[Callable[..., Set[str]]] = None
                   ) -> Tuple[Callable, Callable]:
    """(gen_step, disc_step).

    ``generator_loss_fn(model, batch, generator, draws, **kwargs) ->
    (base loss (0-d), fake images (B, H, W, C) in [-1, 1])``: the task's
    loss and the sample D judges. ``gen_step(state, disc_state, batch,
    generator=None, draws=None, **kwargs) -> (state, metrics)`` (loss,
    base_loss, g_loss, grad_norm), the keyword arguments passed on to the
    loss and to ``required`` (see ``make_step``). ``disc_step(disc_state,
    real, fake, global_step) -> (disc_state, {'d_loss'})``. Both update
    their state in place. One process: JAX's GAN loop runs one, and the
    discriminator's statistics are not reduced across processes."""
    if process_count() > 1:
        raise NotImplementedError(
            'GAN steps run in one process (the discriminator state is '
            'not reduced across processes), as JAX\'s GAN loop does')
    loss_cfg = loss_cfg or LPIPSWithDiscriminator2D()

    def factor(step: int) -> float:
        return loss_cfg.disc_factor if step >= loss_cfg.disc_start else 0.0

    def total_loss(model, batch, generator, draws, disc=None, step=0,
                   **kwargs):
        base, fake = generator_loss_fn(model, batch, generator, draws,
                                       **kwargs)
        logits_fake = disc(fake, train=True, update_stats=False)
        g_loss = -logits_fake.float().mean()
        loss = base + loss_cfg.disc_weight * factor(step) * g_loss
        return loss, {'base_loss': base.detach(), 'g_loss': g_loss.detach()}

    step_fn = make_step(
        model, total_loss, max_grad_norm, ema_decay,
        None if required is None else
        (lambda disc=None, step=0, **kwargs: required(**kwargs)))

    def gen_step(state: TrainState, disc_state: DiscState,
                 batch: Dict[str, Tensor],
                 generator: Optional[torch.Generator] = None,
                 draws: Optional[Dict[str, Tensor]] = None, **kwargs):
        with _frozen(disc_state.disc):
            return step_fn(state, batch, generator, draws,
                           disc=disc_state.disc, step=state.step, **kwargs)

    def disc_step(disc_state: DiscState, real: Tensor, fake: Tensor,
                  global_step: int):
        disc, opt = disc_state.disc, disc_state.optimizer
        opt.zero_grad(set_to_none=True)
        logits_real = disc(real, train=True)
        logits_fake = disc(fake.detach(), train=True)
        fn = (hinge_d_loss if loss_cfg.disc_loss == 'hinge'
              else vanilla_d_loss)
        d_loss = factor(int(global_step)) * fn(logits_real.float(),
                                               logits_fake.float())
        d_loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        disc_state.step += 1
        return disc_state, {'d_loss': d_loss.detach()}

    return gen_step, disc_step
