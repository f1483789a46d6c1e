"""FiT transformer building blocks as ``torch.nn`` modules.

Counterpart of fitv2_tpu/models/modules.py, forward only. Submodule and
parameter names follow the JAX package's flax names (``mlp_0``, ``fc_out``,
``embedding_table`` ...) so a JAX parameter tree maps onto ``state_dict()``
by transposing Dense kernels (fitv2_tpu_torch/ckpt/convert.py).

Padded variable-length sequences use a key-side padding mask plus zeroing
of padded query rows before the output projection; norms are computed in
float32 whatever the compute dtype; RoPE tables are computed outside the
block stack and passed in.

The hot chain of every block goes through the hand-written kernels:
``norm_modulate`` -> kernels/fused_adaln.py, the q/k LayerNorm + split RoPE
-> kernels/fused_qk_rope.py, the attention -> kernels/attention.py.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from fitv2_tpu_torch.kernels.attention import masked_attention
from fitv2_tpu_torch.kernels.fused_adaln import adaln_norm
from fitv2_tpu_torch.kernels.fused_qk_rope import qk_norm_rope
from fitv2_tpu_torch.models.rope import apply_rope

Tensor = torch.Tensor


def _expand_mod(m: Tensor, x: Tensor) -> Tensor:
    """(B, D) conditioning -> (B, 1, D); (B, N, D) passes through."""
    return m[:, None, :] if m.dim() == x.dim() - 1 else m


def modulate(x: Tensor, shift: Tensor, scale: Tensor) -> Tensor:
    """AdaLN modulation: x * (1 + scale) + shift."""
    return x * (1.0 + _expand_mod(scale, x)) + _expand_mod(shift, x)


def norm_modulate(x: Tensor, shift: Tensor, scale: Tensor, norm: 'LayerNorm',
                  eps: float = 1e-6) -> Tensor:
    """modulate(norm(x), shift, scale); the plain no-affine LayerNorm with
    (B, D) conditioning (the hot path of every block) is the fused kernel."""
    if norm.norm_type == 'layernorm' and shift.dim() == 2 and scale.dim() == 2:
        return adaln_norm(x, shift, scale, eps)
    return modulate(norm(x), shift, scale)


def _norm_no_affine(x: Tensor, eps: float = 1e-6) -> Tensor:
    """LayerNorm without affine params, computed in fp32."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = x32.var(-1, unbiased=False, keepdim=True)
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)


class LayerNorm(nn.Module):
    """Norm factory: 'layernorm' (no affine), 'w_layernorm' (weight only),
    'rmsnorm'/'w_rmsnorm' (weight), 'none'/None (identity)."""

    def __init__(self, norm_type: Optional[str], dim: int, eps: float = 1e-6):
        super().__init__()
        self.norm_type = (norm_type or 'none').lower()
        self.eps = eps
        if self.norm_type not in ('none', '', 'layernorm', 'w_layernorm',
                                  'rmsnorm', 'w_rmsnorm'):
            raise NotImplementedError(f'Unknown norm_type: {norm_type!r}')
        if self.norm_type in ('w_layernorm', 'rmsnorm', 'w_rmsnorm'):
            self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: Tensor) -> Tensor:
        nt = self.norm_type
        if nt in ('none', ''):
            return x
        if nt in ('layernorm', 'w_layernorm'):
            y = _norm_no_affine(x, self.eps)
            return y * self.weight.to(y.dtype) if nt == 'w_layernorm' else y
        x32 = x.float()
        y = (x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True)
                               + self.eps)).to(x.dtype)
        return y * self.weight.to(y.dtype)


class PatchEmbedder(nn.Module):
    """Linear projection of p**2 * C latent patches."""

    def __init__(self, in_dim: int, embed_dim: int, bias: bool = True):
        super().__init__()
        self.proj = nn.Linear(in_dim, embed_dim, bias=bias)

    def forward(self, x: Tensor) -> Tensor:
        return self.proj(x)


class TimestepEmbedder(nn.Module):
    """Sinusoidal timestep embedding -> 2-layer SiLU MLP.

    The sinusoid concatenates [cos, sin], cos first.
    """

    def __init__(self, hidden_size: int, frequency_embedding_size: int = 256):
        super().__init__()
        self.frequency_embedding_size = frequency_embedding_size
        self.mlp_0 = nn.Linear(frequency_embedding_size, hidden_size)
        self.mlp_2 = nn.Linear(hidden_size, hidden_size)

    @staticmethod
    def timestep_embedding(t: Tensor, dim: int,
                           max_period: float = 10000.0) -> Tensor:
        half = dim // 2
        freqs = torch.exp(-math.log(max_period) * torch.arange(
            half, dtype=torch.float32, device=t.device) / half)
        args = t.float()[:, None] * freqs[None]
        emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
        if dim % 2:
            emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
        return emb

    def forward(self, t: Tensor) -> Tensor:
        x = self.timestep_embedding(t, self.frequency_embedding_size)
        return self.mlp_2(F.silu(self.mlp_0(x.to(self.mlp_0.weight.dtype))))


class LabelEmbedder(nn.Module):
    """Class-label embedding table with the CFG null class as its last row
    (``num_classes + 1`` rows when class dropout is on)."""

    def __init__(self, num_classes: int, hidden_size: int,
                 dropout_prob: float = 0.1):
        super().__init__()
        self.num_classes = num_classes
        rows = num_classes + int(dropout_prob > 0)
        self.embedding_table = nn.Parameter(torch.zeros(rows, hidden_size))
        nn.init.normal_(self.embedding_table, std=0.02)

    def forward(self, labels: Tensor) -> Tensor:
        return self.embedding_table[labels.long()]


class SwiGLU(nn.Module):
    """fc2(silu(g) * v) with the two up-projections fused into one ``fc1``
    GEMM whose output columns are laid out [g | v]."""

    def __init__(self, in_features: int, hidden_features: int,
                 out_features: Optional[int] = None, bias: bool = True):
        super().__init__()
        self.fc1 = nn.Linear(in_features, 2 * hidden_features, bias=bias)
        self.fc2 = nn.Linear(hidden_features, out_features or in_features,
                             bias=bias)

    def forward(self, x: Tensor) -> Tensor:
        g, v = self.fc1(x).chunk(2, dim=-1)
        return self.fc2(F.silu(g) * v)


class Mlp(nn.Module):
    """GELU(tanh) MLP (FiTv1 blocks)."""

    def __init__(self, in_features: int, hidden_features: int,
                 out_features: Optional[int] = None, bias: bool = True):
        super().__init__()
        self.fc1 = nn.Linear(in_features, hidden_features, bias=bias)
        self.fc2 = nn.Linear(hidden_features, out_features or in_features,
                             bias=bias)

    def forward(self, x: Tensor) -> Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate='tanh'))


class Attention(nn.Module):
    """Multi-head attention over padded token sequences with 2D RoPE.

    One fused qkv projection; optional per-head q/k norm; RoPE of q/k; the
    mask-aware softmax attention; outputs of padded queries zeroed before
    the output projection.
    """

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 q_norm: Optional[str] = None, k_norm: Optional[str] = None,
                 qk_norm_weight: bool = False, use_rope: bool = True,
                 add_rel_pe_to_v: bool = False, attn_impl: str = 'auto',
                 save_attention: bool = False, rope_layout: str = 'split',
                 quantized: bool = False):
        super().__init__()
        if quantized:
            raise NotImplementedError(
                'int8 W8A8 GEMMs (gemm_precision=int8) belong to the int8 '
                'serving slice and are not ported yet')
        if save_attention:
            raise NotImplementedError(
                'save_attention (attention-map capture) is not ported yet')
        if add_rel_pe_to_v:
            raise NotImplementedError('add_rel_pe_to_v is not ported yet')
        if attn_impl == 'fused':
            raise NotImplementedError(
                "attn_impl='fused' (the qk-LN + RoPE + attention megakernel) "
                'is not ported yet')
        if attn_impl != 'auto':
            raise ValueError(f'attn_impl={attn_impl!r}: the port picks the '
                             "attention path by device; use 'auto'")
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.q_norm_type = q_norm
        self.k_norm_type = k_norm
        self.qk_norm_weight = qk_norm_weight
        self.use_rope = use_rope
        self.rope_layout = rope_layout
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)

        def norm_type(t):
            return 'w_layernorm' if t == 'layernorm' and qk_norm_weight else t

        self.q_norm = LayerNorm(norm_type(q_norm), self.head_dim)
        self.k_norm = LayerNorm(norm_type(k_norm), self.head_dim)
        self.proj = nn.Linear(dim, dim)
        # fused q/k LN + split RoPE: the hot FiTv2 configuration
        self.fuse_qk = (use_rope and rope_layout == 'split'
                        and not qk_norm_weight
                        and q_norm in (None, 'layernorm')
                        and k_norm in (None, 'layernorm'))
        # no-affine LN on both q and k bounds every row to L2 norm sqrt(Dh),
        # so |logit| <= sqrt(Dh) and the softmax may skip its max pass
        self.bounded = (q_norm == 'layernorm' and k_norm == 'layernorm'
                        and not qk_norm_weight)

    def forward(self, x: Tensor, mask: Optional[Tensor] = None,
                freqs_cos: Optional[Tensor] = None,
                freqs_sin: Optional[Tensor] = None) -> Tensor:
        B, N, C = x.shape
        H, Dh = self.num_heads, self.head_dim
        # views of the fused projection: columns [0:C]=q, [C:2C]=k, [2C:3C]=v
        q, k, v = self.qkv(x).view(B, N, 3, H, Dh).unbind(2)
        if self.fuse_qk and freqs_cos is not None:
            q, k = qk_norm_rope(q, k, freqs_cos, freqs_sin,
                                norm_q=self.q_norm_type == 'layernorm',
                                norm_k=self.k_norm_type == 'layernorm')
        else:
            q, k = self.q_norm(q), self.k_norm(k)
            if self.use_rope and freqs_cos is not None:
                cos = freqs_cos[:, :, None, :].to(q.dtype)
                sin = freqs_sin[:, :, None, :].to(q.dtype)
                q = apply_rope(q, cos, sin, self.rope_layout)
                k = apply_rope(k, cos, sin, self.rope_layout)
        out = masked_attention(q, k, v, mask, bounded_logits=self.bounded)
        out = out.reshape(B, N, C)
        if mask is not None:
            out = out * mask.to(out.dtype)[..., None]  # zero padded queries
        return self.proj(out)


class AdaLNModulation(nn.Module):
    """Produces n_chunks * D modulation params (the FiT zero-inits the last
    layer).

    'normal': SiLU -> fc_out; 'lora': SiLU -> fc1 (rank r) -> fc_out;
    'swiglu': fc2(silu(fc1_g(c)) * fc1_x(c)).
    """

    def __init__(self, hidden_size: int, n_chunks: int,
                 adaln_type: str = 'normal', lora_dim: Optional[int] = None,
                 bias: bool = True):
        super().__init__()
        self.adaln_type = adaln_type
        n_out = n_chunks * hidden_size
        if adaln_type in ('normal', 'lora'):
            width = hidden_size
            if adaln_type == 'lora':
                self.fc1 = nn.Linear(hidden_size, lora_dim, bias=bias)
                width = lora_dim
            self.fc_out = nn.Linear(width, n_out, bias=bias)
        elif adaln_type == 'swiglu':
            hidden = (hidden_size // 4) * 3 if n_chunks == 6 \
                else hidden_size // 2
            self.fc1_g = nn.Linear(hidden_size, hidden, bias=bias)
            self.fc1_x = nn.Linear(hidden_size, hidden, bias=bias)
            self.fc2 = nn.Linear(hidden, n_out, bias=bias)
        else:
            raise NotImplementedError(adaln_type)

    def forward(self, c: Tensor) -> Tensor:
        if self.adaln_type == 'swiglu':
            return self.fc2(F.silu(self.fc1_g(c)) * self.fc1_x(c))
        h = F.silu(c)
        if self.adaln_type == 'lora':
            h = self.fc1(h)
        return self.fc_out(h)


class FiTBlock(nn.Module):
    """AdaLN-zero transformer block."""

    def __init__(self, hidden_size: int, num_heads: int,
                 mlp_ratio: float = 4.0, swiglu: bool = True,
                 swiglu_large: bool = False, norm_layer: str = 'layernorm',
                 q_norm: Optional[str] = None, k_norm: Optional[str] = None,
                 qk_norm_weight: bool = False, qkv_bias: bool = True,
                 ffn_bias: bool = True, adaln_bias: bool = True,
                 adaln_type: str = 'normal',
                 adaln_lora_dim: Optional[int] = None, use_rope: bool = True,
                 add_rel_pe_to_v: bool = False, attn_impl: str = 'auto',
                 save_attention: bool = False, rope_layout: str = 'split',
                 quantized: bool = False):
        super().__init__()
        D = hidden_size
        self.adaLN_modulation = AdaLNModulation(
            D, 6, adaln_type=adaln_type, lora_dim=adaln_lora_dim,
            bias=adaln_bias)
        self.norm1 = LayerNorm(norm_layer, D)
        self.attn = Attention(
            D, num_heads, qkv_bias=qkv_bias, q_norm=q_norm, k_norm=k_norm,
            qk_norm_weight=qk_norm_weight, use_rope=use_rope,
            add_rel_pe_to_v=add_rel_pe_to_v, attn_impl=attn_impl,
            save_attention=save_attention, rope_layout=rope_layout,
            quantized=quantized)
        self.norm2 = LayerNorm(norm_layer, D)
        mlp_hidden = int(D * mlp_ratio)
        if swiglu:
            hidden = mlp_hidden if swiglu_large else (mlp_hidden * 2) // 3
            self.mlp = SwiGLU(D, hidden, bias=ffn_bias)
        else:
            self.mlp = Mlp(D, mlp_hidden, bias=ffn_bias)

    def forward(self, x: Tensor, c: Tensor, mask: Optional[Tensor],
                freqs_cos: Optional[Tensor], freqs_sin: Optional[Tensor],
                global_adaln: Union[Tensor, float] = 0.0) -> Tensor:
        mod = self.adaLN_modulation(c) + global_adaln
        (shift_msa, scale_msa, gate_msa,
         shift_mlp, scale_mlp, gate_mlp) = mod.chunk(6, dim=-1)
        h = norm_modulate(x, shift_msa, scale_msa, self.norm1)
        x = x + _expand_mod(gate_msa, x) * self.attn(h, mask, freqs_cos,
                                                      freqs_sin)
        h = norm_modulate(x, shift_mlp, scale_mlp, self.norm2)
        return x + _expand_mod(gate_mlp, x) * self.mlp(h)


class FinalLayer(nn.Module):
    """Final modulated projection to patch outputs; the 'lora' adaLN type
    uses a 'normal' modulation here (the FiT zero-inits the projection)."""

    def __init__(self, hidden_size: int, patch_size: int, out_channels: int,
                 norm_layer: str = 'layernorm', adaln_bias: bool = True,
                 adaln_type: str = 'normal'):
        super().__init__()
        self.adaLN_modulation = AdaLNModulation(
            hidden_size, 2,
            adaln_type='swiglu' if adaln_type == 'swiglu' else 'normal',
            bias=adaln_bias)
        self.norm_final = LayerNorm(norm_layer, hidden_size)
        self.linear = nn.Linear(hidden_size,
                                patch_size * patch_size * out_channels)

    def forward(self, x: Tensor, c: Tensor) -> Tensor:
        shift, scale = self.adaLN_modulation(c).chunk(2, dim=-1)
        return self.linear(norm_modulate(x, shift, scale, self.norm_final))
