"""SD-VAE (AutoencoderKL) decoder as ``torch.nn`` modules.

Counterpart of the decode half of fitv2_tpu/vae/autoencoder_kl.py: the
SD v1 KL-f8 decoder (``post_quant_conv`` -> ``Decoder``: conv_in, a mid
block of two resnets around single-head attention, up blocks of three
resnets with nearest x2 upsampling, GroupNorm + SiLU + conv_out). Module
and parameter names are diffusers' own, so a published diffusers state dict
loads as it is (vae/torch_import.py). The encoder belongs to a later slice.

Convolutions run in the module's dtype (bf16 for serving); GroupNorm
statistics and the mid-block softmax run in float32. ``decode`` takes and
returns NHWC tensors, the JAX package's layout at this boundary.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

Tensor = torch.Tensor

SD_VAE_SCALE = 0.18215


class GroupNorm32(nn.GroupNorm):
    """GroupNorm(32) computed in float32 (eps 1e-6); C groups when C < 32
    (tiny test configs; every SD-VAE width is a multiple of 32)."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__(32 if channels >= 32 else channels, channels, eps=eps)

    def forward(self, x: Tensor) -> Tensor:
        return F.group_norm(x.float(), self.num_groups, self.weight.float(),
                            self.bias.float(), self.eps).to(x.dtype)


class ResnetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.norm1 = GroupNorm32(in_channels)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.norm2 = GroupNorm32(out_channels)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        if in_channels != out_channels:
            self.conv_shortcut = nn.Conv2d(in_channels, out_channels, 1)

    def forward(self, x: Tensor) -> Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, 'conv_shortcut'):
            x = self.conv_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head self-attention over the spatial grid (mid block).
    A plain matmul + float32 softmax: it runs once per decode."""

    def __init__(self, channels: int):
        super().__init__()
        self.group_norm = GroupNorm32(channels)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x: Tensor) -> Tensor:
        B, C, H, W = x.shape
        h = self.group_norm(x).reshape(B, C, H * W).transpose(1, 2)
        q, k, v = self.to_q(h), self.to_k(h), self.to_v(h)
        attn = torch.softmax((q.float() @ k.float().transpose(1, 2))
                             * (C ** -0.5), dim=-1).to(v.dtype)
        out = self.to_out[0](attn @ v)
        return x + out.transpose(1, 2).reshape(B, C, H, W)


class Upsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x: Tensor) -> Tensor:
        return self.conv(F.interpolate(x, scale_factor=2.0, mode='nearest'))


class MidBlock(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock(channels, channels),
                                      ResnetBlock(channels, channels)])
        self.attentions = nn.ModuleList([AttnBlock(channels)])

    def forward(self, x: Tensor) -> Tensor:
        x = self.resnets[0](x)
        x = self.attentions[0](x)
        return self.resnets[1](x)


class UpBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, layers: int,
                 upsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock(in_channels if j == 0 else out_channels, out_channels)
            for j in range(layers)])
        if upsample:
            self.upsamplers = nn.ModuleList([Upsample(out_channels)])

    def forward(self, x: Tensor) -> Tensor:
        for r in self.resnets:
            x = r(x)
        if hasattr(self, 'upsamplers'):
            x = self.upsamplers[0](x)
        return x


class Decoder(nn.Module):
    """z (B, latent, h, w) -> image (B, 3, 2**(L-1) h, 2**(L-1) w), NCHW."""

    def __init__(self, block_out_channels: Sequence[int] = (128, 256, 512, 512),
                 layers_per_block: int = 3, latent_channels: int = 4,
                 out_channels: int = 3):
        super().__init__()
        ch = list(reversed(block_out_channels))
        self.conv_in = nn.Conv2d(latent_channels, ch[0], 3, padding=1)
        self.mid_block = MidBlock(ch[0])
        self.up_blocks = nn.ModuleList([
            UpBlock(ch[max(i - 1, 0)], c, layers_per_block,
                    upsample=i < len(ch) - 1) for i, c in enumerate(ch)])
        self.conv_norm_out = GroupNorm32(ch[-1])
        self.conv_out = nn.Conv2d(ch[-1], out_channels, 3, padding=1)

    def forward(self, z: Tensor) -> Tensor:
        h = self.mid_block(self.conv_in(z))
        for block in self.up_blocks:
            h = block(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class AutoencoderKL(nn.Module):
    """The decode half of SD's AutoencoderKL (post_quant_conv + Decoder)."""

    def __init__(self, block_out_channels: Sequence[int] = (128, 256, 512, 512),
                 latent_channels: int = 4, layers_per_block: int = 3):
        super().__init__()
        self.decoder = Decoder(block_out_channels, layers_per_block,
                               latent_channels)
        self.post_quant_conv = nn.Conv2d(latent_channels, latent_channels, 1)

    @property
    def dtype(self) -> torch.dtype:
        return self.post_quant_conv.weight.dtype

    def decode(self, z: Tensor) -> Tensor:
        """z: (B, h, w, latent) NHWC -> image (B, H, W, 3) NHWC, in [-1, 1]
        for a trained decoder."""
        x = z.permute(0, 3, 1, 2).to(self.dtype)
        x = self.decoder(self.post_quant_conv(x))
        return x.permute(0, 2, 3, 1)


def images_to_uint8(images: Tensor) -> Tensor:
    """[-1, 1] float -> uint8: clip to [-1, 1], then 127.5 x + 128 clipped
    to [0, 255], then a truncating cast."""
    x = torch.clamp(images.float(), -1.0, 1.0)
    return torch.clamp(127.5 * x + 128.0, 0, 255).to(torch.uint8)
