"""OpenAI CLIP's visual tower (ViT), a REPA teacher.

Counterpart of fitv2_tpu/encoders/clip.py: a patchify convolution without
bias, a learned class embedding and position embedding, ``ln_pre``,
residual blocks of pre-LN attention (``torch.nn.MultiheadAttention``'s
packed ``in_proj``) and quickGELU MLPs, then ``ln_post`` on the class
token and the projection. ``forward`` returns (tokens with the class
token, the pooled projection); ``forward_features`` the REPA teacher's
tokens (class token dropped, no projection). Parameter names are
OpenAI's ``visual`` tower's.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch
from torch import nn

from fitv2_tpu_torch.encoders.vit import attention

Tensor = torch.Tensor


def quick_gelu(x: Tensor) -> Tensor:
    """CLIP's QuickGELU: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


class CLIPAttention(nn.Module):
    """``nn.MultiheadAttention``'s self attention and parameter names."""

    def __init__(self, width: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = nn.Linear(width, width)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, x: Tensor) -> Tensor:
        qkv = nn.functional.linear(x, self.in_proj_weight, self.in_proj_bias)
        return self.out_proj(attention(qkv, self.num_heads))


class CLIPMlp(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.c_fc = nn.Linear(width, 4 * width)
        self.c_proj = nn.Linear(4 * width, width)

    def forward(self, x: Tensor) -> Tensor:
        return self.c_proj(quick_gelu(self.c_fc(x)))


class CLIPBlock(nn.Module):
    """ResidualAttentionBlock: pre-LN attention, then a quickGELU MLP."""

    def __init__(self, width: int, num_heads: int):
        super().__init__()
        self.ln_1 = nn.LayerNorm(width, eps=1e-5)
        self.attn = CLIPAttention(width, num_heads)
        self.ln_2 = nn.LayerNorm(width, eps=1e-5)
        self.mlp = CLIPMlp(width)

    def forward(self, x: Tensor) -> Tensor:
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class CLIPVisionTransformer(nn.Module):
    """x (B, H, W, 3) NHWC, CLIP-normalised."""

    def __init__(self, image_size: int = 224, patch_size: int = 14,
                 width: int = 1024, depth: int = 24, num_heads: int = 16,
                 output_dim: int = 768):
        super().__init__()
        self.image_size = image_size
        n = (image_size // patch_size) ** 2
        self.conv1 = nn.Conv2d(3, width, patch_size, stride=patch_size,
                               bias=False)
        self.class_embedding = nn.Parameter(torch.randn(width) * 0.02)
        self.positional_embedding = nn.Parameter(
            torch.randn(n + 1, width) * 0.01)
        self.ln_pre = nn.LayerNorm(width, eps=1e-5)
        self.transformer = nn.Module()
        self.transformer.resblocks = nn.ModuleList([
            CLIPBlock(width, num_heads) for _ in range(depth)])
        self.ln_post = nn.LayerNorm(width, eps=1e-5)
        self.proj = nn.Parameter(torch.randn(width, output_dim) * 0.01)

    def forward(self, x: Tensor) -> Tuple[Tensor, Tensor]:
        """-> (tokens (B, 1 + N, width) with the class token first, the
        pooled projection (B, output_dim))."""
        h = self.conv1(x.permute(0, 3, 1, 2).to(self.proj.dtype))
        B, C = h.shape[:2]
        h = h.flatten(2).transpose(1, 2)
        h = torch.cat([self.class_embedding.to(h.dtype).expand(B, 1, C), h],
                      dim=1)
        h = self.ln_pre(h + self.positional_embedding.to(h.dtype)[None])
        for block in self.transformer.resblocks:
            h = block(h)
        pooled = self.ln_post(h[:, 0])
        return h, pooled @ self.proj.to(pooled.dtype)

    def forward_features(self, x: Tensor) -> Tensor:
        """The REPA teacher's tokens: class token dropped, no projection."""
        return self(x)[0][:, 1:]


def clip_vit_b16(**kw) -> CLIPVisionTransformer:
    return CLIPVisionTransformer(patch_size=16, width=768, depth=12,
                                 num_heads=12, output_dim=512, **kw)


def clip_vit_l14(**kw) -> CLIPVisionTransformer:
    return CLIPVisionTransformer(patch_size=14, width=1024, depth=24,
                                 num_heads=16, output_dim=768, **kw)


def convert_clip_visual_state_dict(sd: Mapping[str, Tensor]
                                   ) -> Dict[str, Tensor]:
    """An OpenAI CLIP state dict (the whole model, keys under ``visual.``,
    or the visual tower alone) -> the port's (the text tower dropped)."""
    if any(k.startswith('visual.') for k in sd):
        sd = {k[len('visual.'):]: v for k, v in sd.items()
              if k.startswith('visual.')}
    return {k: torch.as_tensor(v).float() for k, v in sd.items()}
