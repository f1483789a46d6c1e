"""LwD / BFM segment-flow train steps: reflow (+ REPA), distillation from a
frozen teacher, the mid-block forecaster's finetune and multi-scale tiers.

Counterpart of fitv2_tpu/train/lwd_train_step.py on the port's train-step
machinery (``train_step.make_step``: masters -> compute copy, backward,
gradients -> fp32 masters, clip, AdamW, EMA; JAX's ``_apply_updates`` is
its update half). Each `make_*` function here returns

    train_step(state, batch, segment_idx, generator=None, draws=None)
        -> (state, metrics)

which updates ``state`` in place (``state.step`` counts segment updates).
A segment update touches one segment's parameters; every other parameter
gets a zero gradient, as ``jax.value_and_grad`` gives it, so the global
norm, the clip and AdamW (which decays its moments and moves it by its
momentum) cover the whole model as optax does. Every parameter of segment
k's own stack, embedders and final layer must get a gradient, or the step
raises (a detached output upstream of it).

The draws: x0, then r, then the label drops, from ``generator`` (a CPU
generator, so every device draws the same numbers) in that order, unless
``draws`` gives ``x0`` (the multi-scale step's in the image layout (B, H,
W, C)), ``r`` (B,) or ``drop_ids`` (B,). The finetune step drops no label.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Set, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fitv2_tpu_torch.models.fit_lwd import repa_alignment_loss
from fitv2_tpu_torch.models.grid_utils import make_grid_mask_size
from fitv2_tpu_torch.train.train_step import TrainState, make_step

Tensor = torch.Tensor
Draws = Optional[Dict[str, Tensor]]
SegmentStep = Callable[..., Tuple[TrainState, Dict[str, Tensor]]]
FINETUNE_MODES = ('replace', 'residual', 'blend')


class SegmentSampler:
    """The host's segment-index stream: numpy ``PCG64(seed)``'s
    ``integers(K)``, JAX's stream."""

    def __init__(self, number_of_perflow: int, seed: int = 0):
        self.k = number_of_perflow
        self.rng = np.random.Generator(np.random.PCG64(seed))

    def __call__(self) -> int:
        return int(self.rng.integers(self.k))


def _segment_params(model: nn.Module, extra: Sequence[str] = (),
                    labels: bool = True) -> Callable[..., Set[str]]:
    """``required(segment_idx=k)``: the names of segment k's blocks, its
    embedders (the label table unless ``labels`` is False) and final layer,
    and of the modules named in ``extra``."""
    names = [n for n, _ in model.named_parameters()]
    K = model.number_of_perflow

    def prefixes(k):
        e = k if model.perlayer_embedder else 0
        emb = ('x_embedders', 't_embedders', 'final_layers') + (
            ('y_embedders',) if labels else ())
        return (f'segments.{k}.', *(f'{m}.{e}.' for m in emb),
                *(f'{m}.' for m in extra))

    by_segment = {k: {n for n in names if n.startswith(prefixes(k))}
                  for k in range(K)}

    def required(segment_idx: int) -> Set[str]:
        if segment_idx not in by_segment:
            raise ValueError(f'segment {segment_idx} not in [0, {K})')
        return by_segment[segment_idx]
    return required


def _segment_step(model: nn.Module, loss_fn, max_grad_norm: float,
                  ema_decay: float, required, layout=None) -> SegmentStep:
    step = make_step(model, loss_fn, max_grad_norm, ema_decay, required,
                     layout)

    def train_step(state: TrainState, batch: Dict[str, Tensor],
                   segment_idx: int,
                   generator: Optional[torch.Generator] = None,
                   draws: Draws = None):
        return step(state, batch, generator, draws, segment_idx=segment_idx)
    return train_step


def _x0_r(shape: Tuple[int, ...], like: Tensor,
          generator: Optional[torch.Generator], draws: Draws
          ) -> Tuple[Tensor, Tensor]:
    """x0 ~ N(0, I) of ``shape``, then r ~ U[0, 1) (B,), from ``draws`` or
    the generator, on ``like``'s device and dtype."""
    draws = draws or {}
    x0 = draws.get('x0')
    if x0 is None:
        x0 = torch.randn(shape, generator=generator)
    r = draws.get('r')
    if r is None:
        r = torch.rand((shape[0],), generator=generator)
    return (x0.to(like.device, like.dtype), r.to(like.device, like.dtype))


def _segment_inputs(sigmas: np.ndarray, k: int, x1: Tensor, x0: Tensor,
                    r: Tensor):
    """Segment k's endpoints xt_in (at sigma_k) and xt (sigma_{k+1}), the
    time t = sigma_k + r dsigma and the input lerp(xt_in, xt, r)."""
    s_cur, s_next = float(sigmas[k]), float(sigmas[k + 1])
    xt_in = x0 * (1 - s_cur) + x1 * s_cur
    xt = x0 * (1 - s_next) + x1 * s_next
    t_input = s_cur + r * (s_next - s_cur)
    rb = r.reshape((-1,) + (1,) * (x1.dim() - 1))
    return xt_in, xt, t_input, xt_in * (1 - rb) + xt * rb


def _masked_mse(pred: Tensor, target: Tensor, mask: Tensor) -> Tensor:
    err = (pred.float() - target.float()) * mask[..., None].float()
    return (err ** 2).mean(dim=(1, 2)).mean()


def _forward(model, x, t, batch, k, generator, draws, grid=None, mask=None,
             size=None):
    """One train-mode segment forward: (velocity, REPA projection)."""
    return model.forward_run_layer(
        x, t, batch['label'], k, batch['grid'] if grid is None else grid,
        batch['mask'] if mask is None else mask,
        batch.get('size') if size is None else size, train=True,
        force_drop_ids=(draws or {}).get('drop_ids'), generator=generator)


def make_lwd_train_step(model: nn.Module, max_grad_norm: float = 1.0,
                        ema_decay: float = 0.9999, repa_weight: float = 0.5,
                        layout=None) -> SegmentStep:
    """Random-segment reflow: the masked MSE of segment k's velocity
    against (xt - xt_in) / dsigma, plus ``repa_weight`` times the REPA
    alignment loss when the model has a REPA head and the batch a
    ``repa_target`` (B, N, Drepa). metrics: loss, grad_norm, flow_loss,
    proj_loss."""
    sigmas = model.sigmas

    def loss_fn(model, batch, generator, draws, segment_idx):
        x1 = batch['feature']
        x0, r = _x0_r(tuple(x1.shape), x1, generator, draws)
        xt_in, xt, t_input, x_input = _segment_inputs(sigmas, segment_idx,
                                                      x1, x0, r)
        target = (xt - xt_in) / float(sigmas[segment_idx + 1]
                                      - sigmas[segment_idx])
        pred, repr_proj = _forward(model, x_input, t_input, batch,
                                   segment_idx, generator, draws)
        flow = _masked_mse(pred, target, batch['mask'])
        proj = torch.zeros((), dtype=torch.float32, device=x1.device)
        if repr_proj is not None and 'repa_target' in batch:
            proj = repa_alignment_loss(
                repr_proj.float(), batch['repa_target'].float(),
                batch['mask']).mean()
        return flow + repa_weight * proj, {'flow_loss': flow.detach(),
                                           'proj_loss': proj.detach()}

    return _segment_step(model, loss_fn, max_grad_norm, ema_decay,
                         _segment_params(model), layout=layout)


def make_lwd_distill_step(student: nn.Module,
                          teacher_apply: Callable[[Tensor, Tensor, Dict],
                                                  Tensor],
                          solver_steps: int = 8, max_grad_norm: float = 1.0,
                          ema_decay: float = 0.9999,
                          layout=None) -> SegmentStep:
    """Teacher-trajectory distillation: the segment's end state is the
    frozen teacher's velocity field rolled from xt_in with
    ``solver_steps`` Euler sub-steps over the float64 sub-sigmas (no
    gradient), in place of the data interpolant. ``teacher_apply(x, t,
    batch) -> velocity`` (float32). metrics: loss, grad_norm."""
    sigmas = student.sigmas

    def loss_fn(model, batch, generator, draws, segment_idx):
        x1 = batch['feature']
        x0, r = _x0_r(tuple(x1.shape), x1, generator, draws)
        s_cur = float(sigmas[segment_idx])
        s_next = float(sigmas[segment_idx + 1])
        xt_in = x0 * (1 - s_cur) + x1 * s_cur
        sub = np.linspace(s_cur, s_next, solver_steps + 1)
        xt = xt_in
        with torch.no_grad():
            for i in range(solver_steps):
                tv = torch.full((x1.shape[0],), float(sub[i]),
                                dtype=x1.dtype, device=x1.device)
                xt = xt + float(sub[i + 1] - sub[i]) * teacher_apply(
                    xt, tv, batch)
        t_input = s_cur + r * (s_next - s_cur)
        rb = r.reshape((-1,) + (1,) * (x1.dim() - 1))
        x_input = xt_in * (1 - rb) + xt * rb
        target = (xt - xt_in) / (s_next - s_cur)
        pred, _ = _forward(model, x_input, t_input, batch, segment_idx,
                           generator, draws)
        return _masked_mse(pred, target, batch['mask']), {}

    return _segment_step(student, loss_fn, max_grad_norm, ema_decay,
                         _segment_params(student), layout=layout)


def make_lwd_finetune_step(model: nn.Module, max_grad_norm: float = 1.0,
                           ema_decay: float = 0.9999, mode: str = 'replace',
                           rep_weight: float = 0.0,
                           layout=None) -> SegmentStep:
    """The mid-block forecaster's finetune (a shared-encoder model's
    ``forward_run_layer_finetune``): the forecaster learns the frozen
    encoder's representation at the segment start (t_next = sigma_k,
    xt_next = xt_in); loss = the masked MSE of x_pred against the detached
    x_target, plus ``rep_weight`` times the REPA alignment of rep_pred and
    rep_target (0 by default, as in the reference). The shared encoder and
    the label table get no gradient. metrics: loss, grad_norm, mse (and
    rep_loss)."""
    if mode not in FINETUNE_MODES:
        raise ValueError(f'unknown finetune mode: {mode!r}')
    sigmas = model.sigmas

    def loss_fn(model, batch, generator, draws, segment_idx):
        x1 = batch['feature']
        x0, r = _x0_r(tuple(x1.shape), x1, generator, draws)
        xt_in, _, t_input, x_input = _segment_inputs(sigmas, segment_idx,
                                                     x1, x0, r)
        t_next = torch.full((x1.shape[0],), float(sigmas[segment_idx]),
                            dtype=x1.dtype, device=x1.device)
        out = model.forward_run_layer_finetune(
            x_input, t_input, batch['label'], segment_idx, batch['grid'],
            batch['mask'], t_next, xt_in, batch.get('size'), mode)
        mse = _masked_mse(out['x_pred'], out['x_target'], batch['mask'])
        aux = {'mse': mse.detach()}
        loss = mse
        if rep_weight > 0.0:
            rep = repa_alignment_loss(out['rep_pred'].float(),
                                      out['rep_target'].float(),
                                      batch['mask']).mean()
            aux['rep_loss'] = rep.detach()
            loss = loss + rep_weight * rep
        return loss, aux

    return _segment_step(model, loss_fn, max_grad_norm, ema_decay,
                         _segment_params(model, ['mid_blocks'],
                                         labels=False), layout=layout)


def _tier_of(segment_idx: int, multi_scale_indices) -> int:
    return sum(segment_idx >= b for b in multi_scale_indices)


def _corrected_sigma(s: float, gamma: float = 1.0 / 3.0) -> float:
    """The reference's renoising correction of a tier's start sigma."""
    return (1.0 / (np.sqrt(1.0 + 1.0 / gamma) * (1.0 - s) + s)) * s


def resize_nhwc(img: Tensor, h: int, w: int, method: str) -> Tensor:
    """``jax.image.resize(img, (B, h, w, C), method, antialias=False)`` of
    an NHWC image: 'bilinear' samples at pixel centres (``align_corners``
    False); 'nearest' at an integer upscale repeats pixels."""
    out = F.interpolate(img.permute(0, 3, 1, 2), size=(h, w), mode=method,
                        **({'align_corners': False, 'antialias': False}
                           if method == 'bilinear' else {}))
    return out.permute(0, 2, 3, 1)


def make_lwd_multiscale_train_step(model: nn.Module,
                                   max_grad_norm: float = 1.0,
                                   ema_decay: float = 0.9999,
                                   multi_scale_indices=(2, 7),
                                   gamma: float = 1.0 / 3.0,
                                   layout=None) -> SegmentStep:
    """Multi-scale segment training: ``multi_scale_indices`` group the
    segments into T resolution tiers; tier k trains at 1/2^(T-1-k) of the
    full grid on bilinear-downsampled data and noise (the noise scaled by
    2 per halving), against the coarse ladder linspace(0, 1, T + 1), a
    tier past the first starting from the renoising-corrected sigma and
    the previous tier's image upsampled (nearest). The batch's features
    must be full n_patch_h x n_patch_w token grids; each tier's grid and
    mask are its own. metrics: loss, grad_norm, tier."""
    K = model.number_of_perflow
    bounds = [0, *multi_scale_indices, K]
    n_tiers = len(bounds) - 1
    coarse = np.linspace(0.0, 1.0, n_tiers + 1)
    p, c_lat = model.patch_size, model.in_channels
    H, W = model.n_patch_h * p, model.n_patch_w * p

    def tokens_to_img(x: Tensor) -> Tensor:
        b = x.shape[0]
        x = x.reshape(b, H // p, W // p, c_lat, p, p)
        return torch.einsum('bhwcpq->bhpwqc', x).reshape(b, H, W, c_lat)

    def loss_fn(model, batch, generator, draws, segment_idx):
        x1_img = tokens_to_img(batch['feature'])
        x0_img, r = _x0_r(tuple(x1_img.shape), x1_img, generator, draws)
        tier = _tier_of(segment_idx, multi_scale_indices)
        halvings = n_tiers - 1 - tier
        hx, wx = H >> halvings, W >> halvings
        x = resize_nhwc(x1_img, hx, wx, 'bilinear')
        x0 = resize_nhwc(x0_img, hx, wx, 'bilinear')
        if halvings:
            x0 = x0 * 2.0 ** halvings
        s_start = float(coarse[tier])
        s_end = float(coarse[tier + 1])
        if tier == 0:
            x_start = x0
        else:
            prev_h = H >> (halvings + 1)
            x_past = resize_nhwc(x1_img, prev_h, prev_h * W // H, 'bilinear')
            x_past = resize_nhwc(x_past, hx, wx, 'nearest')
            s_start = _corrected_sigma(s_start, gamma)
            x_start = x0 * (1.0 - s_start) + x_past * s_start
        x_end = x if tier == n_tiers - 1 else x0 * (1.0 - s_end) + x * s_end

        lo, hi = bounds[tier], bounds[tier + 1]
        mod = (segment_idx - lo) / (hi - lo)
        mod_next = (segment_idx - lo + 1) / (hi - lo)
        xt_in = x_start * (1 - mod) + x_end * mod
        xt = x_start * (1 - mod_next) + x_end * mod_next
        sig_cur = s_start + (s_end - s_start) * mod
        sig_next = s_start + (s_end - s_start) * mod_next

        t_input = sig_cur + r * (sig_next - sig_cur)
        rb = r[:, None, None, None]
        x_input = model._repatchify(xt_in * (1 - rb) + xt * rb)
        target = model._repatchify((xt - xt_in) / (sig_next - sig_cur))
        n_h, n_w = hx // p, wx // p
        grid, mask, size = make_grid_mask_size(x.shape[0], n_h, n_w,
                                               n_h * n_w, x.device)
        pred, _ = _forward(model, x_input, t_input, batch, segment_idx,
                           generator, draws, grid, mask, size)
        err = pred.float() - target.float()
        loss = (err ** 2).mean(dim=(1, 2)).mean()
        return loss, {'tier': torch.tensor(float(tier), device=x.device)}

    return _segment_step(model, loss_fn, max_grad_norm, ema_decay,
                         _segment_params(model), layout=layout)
