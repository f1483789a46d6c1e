"""FiTv1 (improved-DDPM epsilon-prediction) train step.

Counterpart of fitv2_tpu/train/ddpm_train_step.py on the port's train-step
machinery (``train_step.make_step``: bf16 compute over fp32 masters, AdamW
with optax's roundings, clipping, EMA): t uniform over the diffusion's
ladder, the masked MSE plus the learned-range variational bound through
``GaussianDiffusion.training_losses``.

The draws (t, the noise, the label drops) come from the step's CPU
generator in that order, or are passed in ``draws`` (``t``, ``noise``,
``drop_ids``), as the flow step's. Importance sampling: a batch that
carries ``t`` (B,) integers and ``t_weight`` (B,) (from
``sched.LossSecondMomentResampler.sample``) uses that t and weighs each
sample's loss; the metrics' ``per_t_loss`` (the unweighted (B,) losses)
and ``t`` feed ``update_with_all_losses``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from fitv2_tpu_torch.sched.gaussian_diffusion import GaussianDiffusion
from fitv2_tpu_torch.train.train_step import TrainState, make_step

Tensor = torch.Tensor


def ddpm_loss(model: nn.Module, diffusion: GaussianDiffusion,
              batch: Dict[str, Tensor],
              generator: Optional[torch.Generator] = None,
              draws: Optional[Dict[str, Tensor]] = None
              ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Mean (importance-weighted) diffusion loss of a train-mode forward
    on ``batch`` (feature, grid, mask, label, size; optionally t and
    t_weight), and the metrics mse (the batch mean), per_t_loss and t."""
    draws = draws or {}
    x = batch['feature']
    if 't' in batch:
        t = batch['t']
    elif 't' in draws:
        t = draws['t']
    else:
        t = torch.randint(0, diffusion.num_timesteps, (x.shape[0],),
                          generator=generator)
    t = t.to(device=x.device, dtype=torch.int64)
    noise = draws.get('noise')
    if noise is None:
        noise = torch.randn(tuple(x.shape), generator=generator)

    def model_fn(xt, t_int):
        return model(xt, t_int.float(), batch['label'], batch['grid'],
                     batch['mask'], batch.get('size'), train=True,
                     force_drop_ids=draws.get('drop_ids'),
                     generator=generator)

    terms = diffusion.training_losses(model_fn, x, t, mask=batch['mask'],
                                      noise=noise)
    per_t = terms['loss']
    if 't_weight' in batch:
        per_t = per_t * batch['t_weight']
    metrics = {'mse': terms.get('mse', terms['loss']).mean().detach(),
               'per_t_loss': terms['loss'].detach(), 't': t}
    return per_t.mean(), metrics


def make_ddpm_train_step(model: nn.Module, diffusion: GaussianDiffusion,
                         max_grad_norm: float = 1.0,
                         ema_decay: float = 0.9999, layout=None
                         ) -> Callable[..., Tuple[TrainState,
                                                  Dict[str, Tensor]]]:
    """``train_step(state, batch, generator=None, draws=None) -> (state,
    metrics)`` of a FiT (``learn_sigma=True`` for the learned-range
    variance) under ``diffusion``'s losses; metrics: loss, grad_norm, mse,
    per_t_loss (B,) and t (B,). ``layout``: as ``make_step``'s."""
    def loss_fn(model, batch, generator, draws):
        return ddpm_loss(model, diffusion, batch, generator, draws)
    return make_step(model, loss_fn, max_grad_norm, ema_decay,
                     layout=layout)
