"""Auxiliary modules of the LwD / BFM family as ``torch.nn`` modules.

Counterpart of fitv2_tpu/models/modules_lwd.py; parameter names follow the
JAX package's flax names (fitv2_tpu_torch/ckpt/convert.py). The LwD
representation block is the FiT block itself (``FiTBlock``).

  - ``FinalLayerNoModulation``: norm -> linear, no conditioning.
  - ``TimestepDependentCoefficient``: sigmoid(MLP(t_emb)), its last layer
    zero with bias -4.6, so it starts near 0.01.
  - ``SRN``: a sigmoid-bounded modulated projection; the conditioning may
    be per token (B, N, D).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fitv2_tpu_torch.models.modules import LayerNorm, modulate

Tensor = torch.Tensor


class FinalLayerNoModulation(nn.Module):
    """norm -> linear; ``c`` is accepted and ignored."""

    def __init__(self, hidden_size: int, patch_size: int, out_channels: int,
                 norm_layer: str = 'layernorm'):
        super().__init__()
        self.norm_final = LayerNorm(norm_layer, hidden_size)
        self.linear = nn.Linear(hidden_size,
                                patch_size * patch_size * out_channels)

    def forward(self, x: Tensor, c: Tensor | None = None) -> Tensor:
        return self.linear(self.norm_final(x))


class TimestepDependentCoefficient(nn.Module):
    """sigmoid(fc2(silu(fc1(t_emb)))) in [0, 1], (B, 1)."""

    def __init__(self, embedding_dim: int):
        super().__init__()
        self.fc1 = nn.Linear(embedding_dim, embedding_dim // 2)
        self.fc2 = nn.Linear(embedding_dim // 2, 1)
        nn.init.zeros_(self.fc2.weight)
        nn.init.constant_(self.fc2.bias, -4.6)

    def forward(self, t_emb: Tensor) -> Tensor:
        return torch.sigmoid(self.fc2(F.silu(self.fc1(t_emb))))


class SRN(nn.Module):
    """sigmoid(linear(modulate(norm(x), shift, scale))) with (shift, scale)
    from the conditioning: 'swiglu' (``adaln_fc1_g``, ``adaln_fc1_x``,
    ``adaln_fc2``) or otherwise SiLU -> ``adaln_fc_out``; ``linear`` starts
    at zero. ``concat_adaln`` doubles the conditioning's width."""

    def __init__(self, hidden_size: int, patch_size: int, out_channels: int,
                 norm_layer: str = 'layernorm', adaln_bias: bool = True,
                 adaln_type: str = 'normal', concat_adaln: bool = False):
        super().__init__()
        self.adaln_type = adaln_type
        c_dim = 2 * hidden_size if concat_adaln else hidden_size
        if adaln_type == 'swiglu':
            self.adaln_fc1_g = nn.Linear(c_dim, hidden_size // 2,
                                         bias=adaln_bias)
            self.adaln_fc1_x = nn.Linear(c_dim, hidden_size // 2,
                                         bias=adaln_bias)
            self.adaln_fc2 = nn.Linear(hidden_size // 2, 2 * hidden_size,
                                       bias=adaln_bias)
        else:
            self.adaln_fc_out = nn.Linear(c_dim, 2 * hidden_size,
                                          bias=adaln_bias)
        self.norm_final = LayerNorm(norm_layer, hidden_size)
        self.linear = nn.Linear(hidden_size, out_channels)
        nn.init.zeros_(self.linear.weight)
        nn.init.zeros_(self.linear.bias)

    def forward(self, x: Tensor, c: Tensor) -> Tensor:
        if self.adaln_type == 'swiglu':
            mod = self.adaln_fc2(F.silu(self.adaln_fc1_g(c))
                                 * self.adaln_fc1_x(c))
        else:
            mod = self.adaln_fc_out(F.silu(c))
        shift, scale = mod.chunk(2, dim=-1)
        return torch.sigmoid(self.linear(
            modulate(self.norm_final(x), shift, scale)))
