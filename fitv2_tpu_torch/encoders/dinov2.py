"""DINOv2 vision transformer, a REPA teacher.

Counterpart of fitv2_tpu/encoders/dinov2.py: the output is
``forward_features``' ``x_norm_patchtokens``. Beyond the generic ViT
(encoders/vit.py): a learned position embedding (cls + patches) resampled
to the input grid, a learned cls token and optional register tokens,
LayerScale on both residual branches, and a GELU MLP (S/B/L) or the fused
SwiGLU one (g). Parameter names are torch hub's (``cls_token``,
``pos_embed``, ``register_tokens``, ``patch_embed.proj``, ``blocks.{i}.{
norm1, attn.qkv, attn.proj, ls1.gamma, norm2, mlp.fc1/fc2 | mlp.w12/w3,
ls2.gamma}``, ``norm``).

The position embedding is resampled as ``jax.image.resize(..., 'cubic')``
does it (``resize_cubic``): Keys' cubic (a = -0.5) with half-pixel centres,
the kernel widened by the scale where an axis shrinks (antialiasing), the
weights of each output renormalised to sum to one. ``F.interpolate``'s
bicubic (a = -0.75, no antialiasing) differs by ~1e-2.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fitv2_tpu_torch.encoders.vit import Attention, Mlp

Tensor = torch.Tensor


def _keys_cubic(x: Tensor) -> Tensor:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def cubic_weights(n_in: int, n_out: int) -> Tensor:
    """(n_in, n_out) float32 resampling weights of one axis, as
    ``jax.image.resize(..., 'cubic')`` computes them (its
    ``compute_weight_mat`` with antialiasing and no translation)."""
    inv_scale = 1.0 / (n_out / n_in)
    inv32 = torch.tensor(inv_scale, dtype=torch.float32)
    kernel_scale = torch.clamp(inv32, min=1.0)
    sample_f = (torch.arange(n_out, dtype=torch.float32) + 0.5) * inv32 - 0.5
    x = (sample_f[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None]
         ).abs() / kernel_scale
    w = _keys_cubic(x)
    total = w.sum(0, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    w = torch.where(total.abs() > eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize_cubic(x: Tensor, out_h: int, out_w: int) -> Tensor:
    """(H, W, C) -> (out_h, out_w, C) in float32, ``jax.image.resize(x,
    (out_h, out_w, C), 'cubic')``."""
    h, w = x.shape[:2]
    x = x.float()
    if h != out_h:
        x = torch.einsum('hwc,hH->Hwc', x, cubic_weights(h, out_h).to(
            x.device))
    if w != out_w:
        x = torch.einsum('hwc,wW->hWc', x, cubic_weights(w, out_w).to(
            x.device))
    return x


class SwiGLUFFN(nn.Module):
    """DINOv2's SwiGLUFFNFused: w3(silu(a) * b), [a | b] = w12(x)."""

    def __init__(self, dim: int, mlp_ratio: float):
        super().__init__()
        hidden = (int(dim * mlp_ratio * 2 / 3) + 7) // 8 * 8
        self.w12 = nn.Linear(dim, 2 * hidden)
        self.w3 = nn.Linear(hidden, dim)

    def forward(self, x: Tensor) -> Tensor:
        a, b = self.w12(x).chunk(2, dim=-1)
        return self.w3(F.silu(a) * b)


class LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x: Tensor) -> Tensor:
        return self.gamma.to(x.dtype) * x


class DinoV2Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 swiglu_ffn: bool = False):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads)
        self.ls1 = LayerScale(dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = (SwiGLUFFN(dim, mlp_ratio) if swiglu_ffn
                    else Mlp(dim, int(dim * mlp_ratio)))
        self.ls2 = LayerScale(dim)

    def forward(self, x: Tensor) -> Tensor:
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


class DinoV2ViT(nn.Module):
    """x (B, H, W, 3) NHWC, encoder-normalised -> normalised patch tokens
    (B, N, D)."""

    def __init__(self, img_size: int = 518, patch_size: int = 14,
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0, num_register_tokens: int = 0,
                 swiglu_ffn: bool = False):
        super().__init__()
        self.img_size = img_size
        self.patch_size = patch_size
        self.num_register_tokens = num_register_tokens
        n_base = (img_size // patch_size) ** 2
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(
            torch.randn(1, 1 + n_base, embed_dim) * 0.02)
        if num_register_tokens:
            self.register_tokens = nn.Parameter(
                torch.zeros(1, num_register_tokens, embed_dim))
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(3, embed_dim, patch_size,
                                          stride=patch_size)
        self.blocks = nn.ModuleList([
            DinoV2Block(embed_dim, num_heads, mlp_ratio, swiglu_ffn)
            for _ in range(depth)])
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6)

    def forward(self, x: Tensor) -> Tensor:
        h = self.patch_embed.proj(x.permute(0, 3, 1, 2).to(
            self.norm.weight.dtype))
        B, C, gh, gw = h.shape
        h = h.flatten(2).transpose(1, 2)
        cls_pos, patch_pos = self.pos_embed[0, :1], self.pos_embed[0, 1:]
        if gh * gw != patch_pos.shape[0]:
            side = int(np.sqrt(patch_pos.shape[0]))
            patch_pos = resize_cubic(patch_pos.reshape(side, side, C), gh,
                                     gw).reshape(gh * gw, C)
        h = h + patch_pos.to(h.dtype)[None]
        tokens = [(self.cls_token[0] + cls_pos).to(h.dtype).expand(B, 1, C)]
        if self.num_register_tokens:
            tokens.append(self.register_tokens.to(h.dtype).expand(
                B, self.num_register_tokens, C))
        h = torch.cat(tokens + [h], dim=1)
        for block in self.blocks:
            h = block(h)
        return self.norm(h)[:, 1 + self.num_register_tokens:]


def dinov2_vits14(**kw) -> DinoV2ViT:
    return DinoV2ViT(embed_dim=384, depth=12, num_heads=6, **kw)


def dinov2_vitb14(**kw) -> DinoV2ViT:
    return DinoV2ViT(embed_dim=768, depth=12, num_heads=12, **kw)


def dinov2_vitl14(**kw) -> DinoV2ViT:
    return DinoV2ViT(embed_dim=1024, depth=24, num_heads=16, **kw)


def dinov2_vitg14(**kw) -> DinoV2ViT:
    return DinoV2ViT(embed_dim=1536, depth=40, num_heads=24,
                     swiglu_ffn=True, **kw)


def convert_dinov2_state_dict(sd: Mapping[str, Tensor]
                              ) -> Dict[str, Tensor]:
    """A torch hub DINOv2 state dict -> the port's: the keys the port holds
    (the head and ``mask_token`` are dropped)."""
    keep = ('cls_token', 'pos_embed', 'register_tokens', 'patch_embed.proj.',
            'blocks.', 'norm.')
    return {k: torch.as_tensor(v).float() for k, v in sd.items()
            if k.startswith(keep)}
