"""Frozen ViT representation encoders (I-JEPA, MAE and DeiT-style).

Counterpart of fitv2_tpu/encoders/vit.py: a conv patch embedding, a fixed
2-D sin-cos position embedding, pre-norm blocks with exact-GELU MLPs and a
final LayerNorm; the output is the patch tokens (``forward_features``),
the representation REPA aligns to. Parameter names are timm's / I-JEPA's
(``patch_embed.proj``, ``blocks.{i}.{norm1, attn.qkv, attn.proj, norm2,
mlp.fc1, mlp.fc2}``, ``norm``), so such a state dict loads as it is.

The attention is the plain product chain (fp32 logits and softmax, the
probabilities cast to v's dtype), as JAX's: no Pallas kernel sits there.
Inputs are NHWC, the JAX package's layout.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

Tensor = torch.Tensor


def sincos_pos_embed_2d(embed_dim: int, grid_size: int) -> np.ndarray:
    """(grid_size**2, embed_dim) float64: the MAE 2-D sin-cos embedding,
    the first half of the channels from the W index, the second from H."""
    coords = np.arange(grid_size, dtype=np.float32)
    grid = np.stack(np.meshgrid(coords, coords), axis=0)  # W first

    def one_d(dim, pos):
        omega = 1.0 / 10000 ** (np.arange(dim // 2, dtype=np.float64)
                                / (dim / 2.0))
        out = np.einsum('m,d->md', pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    return np.concatenate([one_d(embed_dim // 2, grid[0]),
                           one_d(embed_dim // 2, grid[1])], axis=1)


def attention(qkv: Tensor, num_heads: int) -> Tensor:
    """Softmax self-attention of a fused (B, N, 3C) projection laid out
    [q | k | v]: fp32 logits and softmax, probabilities in v's dtype.
    Returns (B, N, C)."""
    B, N, C3 = qkv.shape
    C = C3 // 3
    q, k, v = qkv.view(B, N, 3, num_heads, C // num_heads).unbind(2)
    logits = torch.einsum('bqhd,bkhd->bhqk', q.float(), k.float())
    attn = torch.softmax(logits * (C // num_heads) ** -0.5, dim=-1)
    out = torch.einsum('bhqk,bkhd->bqhd', attn.to(v.dtype), v)
    return out.reshape(B, N, C)


class Attention(nn.Module):
    """A fused [q | k | v] projection, ``attention``, the output
    projection (timm's and DINOv2's ``attn.qkv`` / ``attn.proj``)."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: Tensor) -> Tensor:
        return self.proj(attention(self.qkv(x), self.num_heads))


class Mlp(nn.Module):
    """fc2(GELU(fc1(x))), the exact GELU."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: Tensor) -> Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class ViTBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: Tensor) -> Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class VisionTransformer(nn.Module):
    """x (B, H, W, 3) NHWC, encoder-normalised -> patch tokens (B, N, D)."""

    def __init__(self, img_size: int = 224, patch_size: int = 16,
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0):
        super().__init__()
        self.img_size = img_size
        self.patch_size = patch_size
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(3, embed_dim, patch_size,
                                          stride=patch_size)
        self.blocks = nn.ModuleList([ViTBlock(embed_dim, num_heads, mlp_ratio)
                                     for _ in range(depth)])
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6)

    def forward(self, x: Tensor) -> Tensor:
        h = self.patch_embed.proj(x.permute(0, 3, 1, 2).to(
            self.norm.weight.dtype))
        B, C, gh, gw = h.shape
        h = h.flatten(2).transpose(1, 2)
        pe = torch.from_numpy(sincos_pos_embed_2d(C, gh)).to(h.device,
                                                                h.dtype)
        h = h + pe[None]
        for block in self.blocks:
            h = block(h)
        return self.norm(h)


def vit_base(**kw) -> VisionTransformer:
    return VisionTransformer(embed_dim=768, depth=12, num_heads=12, **kw)


def vit_large(**kw) -> VisionTransformer:
    return VisionTransformer(embed_dim=1024, depth=24, num_heads=16, **kw)


def vit_huge(**kw) -> VisionTransformer:
    """I-JEPA ViT-H/14."""
    return VisionTransformer(patch_size=14, embed_dim=1280, depth=32,
                             num_heads=16, **kw)


def convert_vit_state_dict(sd: Mapping[str, Tensor]) -> Dict[str, Tensor]:
    """A timm / I-JEPA ViT state dict -> the port's: the keys the port
    holds (a classifier head, a cls token or a stored position embedding
    are dropped: the port's embedding is the fixed sin-cos one)."""
    keep = ('patch_embed.proj.', 'blocks.', 'norm.')
    return {k: torch.as_tensor(v).float() for k, v in sd.items()
            if k.startswith(keep)}
