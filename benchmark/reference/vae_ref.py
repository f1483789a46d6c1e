"""Plain float32 SD-VAE decoder (the KL-f8 AutoencoderKL of Stable
Diffusion, arXiv 2112.10752; diffusers' parameter names), written from
the architecture: post_quant_conv, conv_in, a mid block (resnet,
single-head attention over the grid, resnet), up blocks of resnets with a
nearest x2 upsample and a 3x3 conv after all but the last, GroupNorm(32,
eps 1e-6) + SiLU + conv_out. A resnet is GroupNorm, SiLU, conv, GroupNorm,
SiLU, conv, plus the input (through a 1x1 conv where the width changes).

``lowp=True`` computes it in float8 (reference/lowp.py) where a bf16
program holds bf16: each product's operands and output, the norms'
outputs, the activations, the residual sums and the attention's
probabilities; norm statistics and the softmax stay float32: the
control.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from reference.lowp import fp8 as fp8_round

Tensor = torch.Tensor
Spec = Tuple[str, Tuple[int, ...], float, float]

GAIN = 1.0
GAIN_OUT = 0.8        # conv_out: decoded images mostly inside [-1, 1]
STD_BIAS = 0.02
STD_NORM = 0.05       # GroupNorm weights N(1, 0.05)


def _channels(vcfg: Dict) -> List[int]:
    return list(reversed(vcfg['block_out_channels']))


def param_specs(vcfg: Dict) -> List[Spec]:
    """The decoder's parameters (and post_quant_conv's)."""
    specs: List[Spec] = []
    lat = vcfg['latent_channels']

    def conv(name, cout, cin, k, gain=GAIN):
        specs.append((f'{name}.weight', (cout, cin, k, k),
                      gain / math.sqrt(cin * k * k), 0.0))
        specs.append((f'{name}.bias', (cout,), STD_BIAS, 0.0))

    def norm(name, ch):
        specs.append((f'{name}.weight', (ch,), STD_NORM, 1.0))
        specs.append((f'{name}.bias', (ch,), STD_BIAS, 0.0))

    def resnet(name, cin, cout):
        norm(f'{name}.norm1', cin)
        conv(f'{name}.conv1', cout, cin, 3)
        norm(f'{name}.norm2', cout)
        conv(f'{name}.conv2', cout, cout, 3)
        if cin != cout:
            conv(f'{name}.conv_shortcut', cout, cin, 1)

    ch = _channels(vcfg)
    conv('post_quant_conv', lat, lat, 1)
    conv('decoder.conv_in', ch[0], lat, 3)
    resnet('decoder.mid_block.resnets.0', ch[0], ch[0])
    a = 'decoder.mid_block.attentions.0'
    norm(f'{a}.group_norm', ch[0])
    for proj in ('to_q', 'to_k', 'to_v', 'to_out.0'):
        specs.append((f'{a}.{proj}.weight', (ch[0], ch[0]),
                      GAIN / math.sqrt(ch[0]), 0.0))
        specs.append((f'{a}.{proj}.bias', (ch[0],), STD_BIAS, 0.0))
    resnet('decoder.mid_block.resnets.1', ch[0], ch[0])
    for i, c in enumerate(ch):
        cin = ch[max(i - 1, 0)]
        for j in range(vcfg['layers_per_block']):
            resnet(f'decoder.up_blocks.{i}.resnets.{j}', cin if j == 0 else c,
                   c)
        if i < len(ch) - 1:
            conv(f'decoder.up_blocks.{i}.upsamplers.0.conv', c, c, 3)
    norm('decoder.conv_norm_out', ch[-1])
    conv('decoder.conv_out', 3, ch[-1], 3, GAIN_OUT)
    return specs


def decode(P: Dict[str, Tensor], vcfg: Dict, z: Tensor,
           lowp: bool = False) -> Tensor:
    """z (B, h, w, latent) NHWC, already divided by the latent scale ->
    images (B, 8h, 8w, 3) NHWC float32."""
    def q(x):
        return fp8_round(x) if lowp else x

    def conv(x, name, pad):
        return q(F.conv2d(q(x), q(P[f'{name}.weight']), P[f'{name}.bias'],
                          padding=pad))

    def gn(x, name):
        return q(F.group_norm(x, 32 if x.shape[1] >= 32 else x.shape[1],
                              P[f'{name}.weight'], P[f'{name}.bias'], 1e-6))

    def resnet(x, name):
        h = conv(q(F.silu(gn(x, f'{name}.norm1'))), f'{name}.conv1', 1)
        h = conv(q(F.silu(gn(h, f'{name}.norm2'))), f'{name}.conv2', 1)
        if f'{name}.conv_shortcut.weight' in P:
            x = conv(x, f'{name}.conv_shortcut', 0)
        return q(x + h)

    def attention(x, name):
        B, C, H, W = x.shape
        h = gn(x, f'{name}.group_norm').reshape(B, C, H * W).transpose(1, 2)

        def lin(v, proj):
            return q(q(v) @ q(P[f'{name}.{proj}.weight']).t()
                     + P[f'{name}.{proj}.bias'])
        qh, kh, vh = lin(h, 'to_q'), lin(h, 'to_k'), lin(h, 'to_v')
        att = q(torch.softmax(qh @ kh.transpose(1, 2) / math.sqrt(C), dim=-1))
        out = lin(q(att @ vh), 'to_out.0')
        return q(x + out.transpose(1, 2).reshape(B, C, H, W))

    x = conv(z.permute(0, 3, 1, 2).float(), 'post_quant_conv', 0)
    x = conv(x, 'decoder.conv_in', 1)
    x = resnet(x, 'decoder.mid_block.resnets.0')
    x = attention(x, 'decoder.mid_block.attentions.0')
    x = resnet(x, 'decoder.mid_block.resnets.1')
    ch = _channels(vcfg)
    for i in range(len(ch)):
        for j in range(vcfg['layers_per_block']):
            x = resnet(x, f'decoder.up_blocks.{i}.resnets.{j}')
        if i < len(ch) - 1:
            x = F.interpolate(x, scale_factor=2.0, mode='nearest')
            x = conv(x, f'decoder.up_blocks.{i}.upsamplers.0.conv', 1)
    x = conv(q(F.silu(gn(x, 'decoder.conv_norm_out'))), 'decoder.conv_out', 1)
    return x.permute(0, 2, 3, 1)


def to_uint8(images: Tensor) -> Tensor:
    """[-1, 1] -> uint8: 127.5 x + 128 clipped to [0, 255], truncated."""
    x = torch.clamp(images.float(), -1.0, 1.0)
    return torch.clamp(127.5 * x + 128.0, 0, 255).to(torch.uint8)
