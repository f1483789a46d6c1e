"""Perceptual and GAN losses: LPIPS, the PatchGAN discriminators, the hinge
and vanilla discriminator losses and the adaptive weight.

Counterpart of fitv2_tpu/losses/perceptual.py, with its interface: images
NHWC in [-1, 1] (NDHWC for the 3D discriminator), permuted once to torch's
channel-first layout inside each module. Parameter names follow the flax
names (``conv0``, ``bn1``, ``vgg.conv3``, ``lin2``), so
``ckpt.disc_state_from_jax`` / ``ckpt.lpips_state_from_jax`` carry JAX's
trees across. Initialisation is flax's: convolutions ``lecun_normal`` with
zero bias; BatchNorm scale 1, bias 0, running mean 0 and variance 1.

BatchNorm follows flax's ``nn.BatchNorm`` (momentum 0.99, eps 1e-5): in
training it normalises with the batch mean and the biased variance
``max(E[x^2] - E[x]^2, 0)`` and moves the running statistics by
``0.99 * old + 0.01 * batch`` with that same biased variance
(``nn.BatchNorm2d`` would store the unbiased one). ``update_stats=False``
normalises with the batch statistics and leaves the running ones alone
(JAX's generator step, which discards the discriminator's new stats).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

Tensor = torch.Tensor


# -- GAN losses ---------------------------------------------------------------

def hinge_d_loss(logits_real: Tensor, logits_fake: Tensor) -> Tensor:
    loss_real = F.relu(1.0 - logits_real).mean()
    loss_fake = F.relu(1.0 + logits_fake).mean()
    return 0.5 * (loss_real + loss_fake)


def vanilla_d_loss(logits_real: Tensor, logits_fake: Tensor) -> Tensor:
    return 0.5 * (F.softplus(-logits_real).mean()
                  + F.softplus(logits_fake).mean())


def adopt_weight(weight: float, global_step, threshold: int = 0,
                 value: float = 0.0) -> Tensor:
    """``value`` until ``global_step`` reaches ``threshold``, then
    ``weight`` (a float32 0-d tensor on ``global_step``'s device)."""
    step = torch.as_tensor(global_step)
    return torch.where(step < threshold,
                       torch.tensor(value, dtype=torch.float32,
                                    device=step.device),
                       torch.tensor(weight, dtype=torch.float32,
                                    device=step.device))


def calculate_adaptive_weight(nll_grad: Tensor, g_grad: Tensor,
                              discriminator_weight: float = 1.0) -> Tensor:
    """|grad nll| / (|grad g| + 1e-4), clamped to [0, 1e4], times
    ``discriminator_weight``: the gradients of each loss with respect to
    the generator's last layer."""
    d_weight = (torch.linalg.vector_norm(nll_grad)
                / (torch.linalg.vector_norm(g_grad) + 1e-4))
    return torch.clamp(d_weight, 0.0, 1e4) * discriminator_weight


# -- flax-faithful layers -----------------------------------------------------

def _lecun_normal_(weight: Tensor) -> Tensor:
    """flax's ``lecun_normal``: variance 1 / fan_in, truncated at two
    standard deviations (of the untruncated normal); a torch conv weight
    (O, I, k...) has fan_in I times the kernel's size."""
    fan_in = weight[0].numel()
    std = (1.0 / fan_in) ** 0.5 / .87962566103423978
    return nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std)


def _conv(dims: int, cin: int, cout: int, kernel: int, stride, padding: int,
          bias: bool = True) -> nn.Module:
    conv = (nn.Conv2d if dims == 2 else nn.Conv3d)(
        cin, cout, kernel, stride=stride, padding=padding, bias=bias)
    _lecun_normal_(conv.weight)
    if bias:
        nn.init.zeros_(conv.bias)
    return conv


class FlaxBatchNorm(nn.Module):
    """flax's ``nn.BatchNorm`` over a channel-first tensor (axis 1)."""

    def __init__(self, features: int, momentum: float = 0.99,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer('running_mean', torch.zeros(features))
        self.register_buffer('running_var', torch.ones(features))

    def forward(self, x: Tensor, train: bool = True,
                update_stats: Optional[bool] = None) -> Tensor:
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if train:
            dims = [0] + list(range(2, x.dim()))
            x32 = x.float()
            mean = x32.mean(dims)
            var = torch.clamp((x32 * x32).mean(dims) - mean * mean, min=0.0)
            if update_stats is None or update_stats:
                with torch.no_grad():
                    m = self.momentum
                    self.running_mean.mul_(m).add_((1 - m) * mean.detach())
                    self.running_var.mul_(m).add_((1 - m) * var.detach())
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x - mean.reshape(shape)) * mul.reshape(shape)
        return (y + self.bias.reshape(shape)).to(x.dtype)


# -- PatchGAN discriminators --------------------------------------------------

class NLayerDiscriminator(nn.Module):
    """The 70x70 PatchGAN; x (B, H, W, C) -> logits (B, h, w, 1)."""

    dims = 2

    def __init__(self, input_nc: int = 3, ndf: int = 64, n_layers: int = 3):
        super().__init__()
        strided = 2 if self.dims == 2 else (1, 2, 2)
        kw, padw = 4, 1
        self.n_layers = n_layers
        self.conv0 = _conv(self.dims, input_nc, ndf, kw, strided, padw)
        nf_prev = 1
        for n in range(1, n_layers):
            nf = min(2 ** n, 8)
            self.add_module(f'conv{n}', _conv(
                self.dims, ndf * nf_prev, ndf * nf, kw, strided, padw,
                bias=False))
            self.add_module(f'bn{n}', FlaxBatchNorm(ndf * nf))
            nf_prev = nf
        nf = min(2 ** n_layers, 8)
        self.add_module(f'conv{n_layers}', _conv(
            self.dims, ndf * nf_prev, ndf * nf, kw, 1, padw, bias=False))
        self.add_module(f'bn{n_layers}', FlaxBatchNorm(ndf * nf))
        self.conv_out = _conv(self.dims, ndf * nf, 1, kw, 1, padw)

    def forward(self, x: Tensor, train: bool = True,
                update_stats: Optional[bool] = None) -> Tensor:
        h = torch.movedim(x, -1, 1)
        h = F.leaky_relu(self.conv0(h), 0.2)
        for n in range(1, self.n_layers + 1):
            h = getattr(self, f'bn{n}')(getattr(self, f'conv{n}')(h), train,
                                        update_stats)
            h = F.leaky_relu(h, 0.2)
        return torch.movedim(self.conv_out(h), 1, -1)


class NLayerDiscriminator3D(NLayerDiscriminator):
    """The 3D PatchGAN over clips: x (B, T, H, W, C) -> logits
    (B, t, h, w, 1); strides (1, 2, 2) where the 2D one strides 2."""

    dims = 3


# -- LPIPS -------------------------------------------------------------------

_VGG16_CFG = (64, 64, 'M', 128, 128, 'M', 256, 256, 256, 'M',
              512, 512, 512, 'M', 512, 512, 512)
# the convs after whose ReLU LPIPS taps: relu1_2, 2_2, 3_3, 4_3, 5_3
_LPIPS_TAPS = (1, 3, 6, 9, 12)
_LPIPS_CHANNELS = (64, 128, 256, 512, 512)
# taming's input scaling
_SHIFT = np.array([-.030, -.088, -.188], np.float32)
_SCALE = np.array([.458, .448, .450], np.float32)
# taming's sequential indices of the VGG convs, slice by slice
_TORCH_SLICE_CONVS = {1: (0, 2), 2: (5, 7), 3: (10, 12, 14),
                      4: (17, 19, 21), 5: (24, 26, 28)}


class _VGG16Features(nn.Module):
    """VGG16's conv stack (``conv0`` .. ``conv12``, 3x3, padding 1) with
    2x2 max pools; returns the five tapped ReLU outputs (NCHW)."""

    def __init__(self):
        super().__init__()
        cin, i = 3, 0
        for v in _VGG16_CFG:
            if v != 'M':
                self.add_module(f'conv{i}', _conv(2, cin, v, 3, 1, 1))
                cin, i = v, i + 1

    def forward(self, x: Tensor):
        feats, i = [], 0
        for v in _VGG16_CFG:
            if v == 'M':
                x = F.max_pool2d(x, 2, 2)
            else:
                x = F.relu(getattr(self, f'conv{i}')(x))
                if i in _LPIPS_TAPS:
                    feats.append(x)
                i += 1
        return feats


class LPIPS(nn.Module):
    """Perceptual distance of x and y (B, H, W, 3) in [-1, 1] -> (B,):
    each tapped VGG feature unit-normalised over channels (+1e-10), the
    squared difference through a 1x1 head ``lin{i}`` (no bias), averaged
    over space, summed over the taps."""

    def __init__(self):
        super().__init__()
        self.vgg = _VGG16Features()
        for i, c in enumerate(_LPIPS_CHANNELS):
            self.add_module(f'lin{i}', _conv(2, c, 1, 1, 1, 0, bias=False))
        self.register_buffer('shift', torch.from_numpy(_SHIFT).reshape(
            1, 3, 1, 1), persistent=False)
        self.register_buffer('scale', torch.from_numpy(_SCALE).reshape(
            1, 3, 1, 1), persistent=False)

    def forward(self, x: Tensor, y: Tensor) -> Tensor:
        xn = (torch.movedim(x, -1, 1) - self.shift) / self.scale
        yn = (torch.movedim(y, -1, 1) - self.shift) / self.scale
        total = 0.0
        for i, (a, b) in enumerate(zip(self.vgg(xn), self.vgg(yn))):
            a = a / (torch.linalg.vector_norm(a, dim=1, keepdim=True) + 1e-10)
            b = b / (torch.linalg.vector_norm(b, dim=1, keepdim=True) + 1e-10)
            lin = getattr(self, f'lin{i}')((a - b) ** 2)
            total = total + lin.mean(dim=(1, 2, 3))
        return total


def convert_lpips_state_dict(sd: Dict[str, np.ndarray]
                             ) -> Dict[str, Tensor]:
    """A taming-transformers LPIPS checkpoint (``net.slice{1..5}.{idx}.
    weight/bias``, ``lin{0..4}.model.1.weight``) -> ``LPIPS.state_dict()``
    (float32; no download: the caller reads a local file)."""
    out: Dict[str, Tensor] = {}
    conv_i = 0
    for s in range(1, 6):
        for idx in _TORCH_SLICE_CONVS[s]:
            for leaf in ('weight', 'bias'):
                out[f'vgg.conv{conv_i}.{leaf}'] = torch.as_tensor(
                    np.asarray(sd[f'net.slice{s}.{idx}.{leaf}'], np.float32))
            conv_i += 1
    for i in range(5):
        out[f'lin{i}.weight'] = torch.as_tensor(
            np.asarray(sd[f'lin{i}.model.1.weight'], np.float32))
    return out


# -- the combined loss --------------------------------------------------------

@dataclasses.dataclass
class LPIPSWithDiscriminator2D:
    """The generator / discriminator loss terms; the caller owns the
    discriminator, LPIPS and the two optimizers."""
    disc_start: int = 0
    disc_factor: float = 1.0
    disc_weight: float = 1.0
    perceptual_weight: float = 1.0
    disc_loss: str = 'hinge'
    pixel_loss: str = 'l1'

    def reconstruction_loss(self, lpips_fn: Optional[Callable],
                            inputs: Tensor, recons: Tensor) -> Tensor:
        """The per-sample pixel loss (l1 or l2, averaged over every
        non-batch axis), plus ``perceptual_weight`` times LPIPS."""
        rec = ((inputs - recons).abs() if self.pixel_loss == 'l1'
               else (inputs - recons) ** 2)
        rec = rec.mean(dim=tuple(range(1, rec.dim())))
        if lpips_fn is not None and self.perceptual_weight > 0:
            rec = rec + self.perceptual_weight * lpips_fn(inputs, recons)
        return rec

    def generator_loss(self, logits_fake: Tensor, nll: Tensor,
                       d_weight, global_step) -> Tensor:
        g_loss = -logits_fake.mean()
        factor = adopt_weight(self.disc_factor, global_step, self.disc_start)
        return nll.mean() + d_weight * factor.to(g_loss.device) * g_loss

    def discriminator_loss(self, logits_real: Tensor, logits_fake: Tensor,
                           global_step) -> Tensor:
        fn = hinge_d_loss if self.disc_loss == 'hinge' else vanilla_d_loss
        factor = adopt_weight(self.disc_factor, global_step, self.disc_start)
        return factor.to(logits_real.device) * fn(logits_real, logits_fake)


# the 3D facade is the same arithmetic over clips: the per-sample reduction
# averages every non-batch axis, the logits come from NLayerDiscriminator3D
LPIPSWithDiscriminator3D = LPIPSWithDiscriminator2D
