"""FiT transformer building blocks as ``torch.nn`` modules.

Counterpart of fitv2_tpu/models/modules.py. Submodule and parameter names
follow the JAX package's flax names (``mlp_0``, ``fc_out``,
``embedding_table`` ...) so a JAX parameter tree maps onto ``state_dict()``
by transposing Dense kernels (fitv2_tpu_torch/ckpt/convert.py).

Padded variable-length sequences use a key-side padding mask plus zeroing
of padded query rows before the output projection; norms are computed in
float32 whatever the compute dtype; RoPE tables are computed outside the
block stack and passed in.

The hot chain of every block goes through the hand-written kernels:
``norm_modulate`` -> kernels/fused_adaln.py, the q/k LayerNorm + split RoPE
-> kernels/fused_qk_rope.py, the attention -> kernels/attention.py; with
``attn_impl='fused'`` the whole attention chain -> kernels/fused_attention.py.
With ``quantized`` (the int8 W8A8 serving mode) the qkv, proj and MLP
GEMMs are ``Int8Linear`` (kernels/quant.py), and a calibrated SwiGLU runs
fc1 + silu * v + requantization and fc2 as two kernels
(kernels/int8_gemm.py).
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from fitv2_tpu_torch.kernels import fused_attention
from fitv2_tpu_torch.kernels.attention import masked_attention
from fitv2_tpu_torch.kernels.fused_adaln import adaln_norm
from fitv2_tpu_torch.kernels.fused_qk_rope import qk_norm_rope
from fitv2_tpu_torch.kernels.int8_gemm import dequant_gemm, swiglu_requant_gemm
from fitv2_tpu_torch.kernels.quant import Int8Linear, quantize_static
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


def _linear(quantized: bool) -> type:
    """Layer class of the hot GEMMs: ``nn.Linear``, or ``Int8Linear`` in
    the int8 serving mode (the same parameters either way)."""
    return Int8Linear if quantized else nn.Linear


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
    (``num_classes + 1`` rows when class dropout is on).

    In training, labels drop to the null class: where ``force_drop_ids ==
    1`` if given (in or out of training), else each with probability
    ``dropout_prob``, drawn on the CPU from ``generator`` (the global CPU
    generator if None), so that the draws do not depend on the device."""

    def __init__(self, num_classes: int, hidden_size: int,
                 dropout_prob: float = 0.1):
        super().__init__()
        self.num_classes = num_classes
        self.dropout_prob = dropout_prob
        rows = num_classes + int(dropout_prob > 0)
        self.embedding_table = nn.Parameter(torch.zeros(rows, hidden_size))
        nn.init.normal_(self.embedding_table, std=0.02)

    def forward(self, labels: Tensor, train: bool = False,
                force_drop_ids: Optional[Tensor] = None,
                generator: Optional[torch.Generator] = None) -> Tensor:
        labels = labels.long()
        if force_drop_ids is not None:
            labels = torch.where(force_drop_ids.to(labels.device) == 1,
                                 self.num_classes, labels)
        elif train and self.dropout_prob > 0:
            drop = torch.rand(labels.shape, generator=generator
                              ) < self.dropout_prob
            labels = torch.where(drop.to(labels.device), self.num_classes,
                                 labels)
        return self.embedding_table[labels]


class SwiGLU(nn.Module):
    """fc2(silu(g) * v) with the two up-projections fused into one ``fc1``
    GEMM whose output columns are laid out [g | v].

    Quantized and calibrated, fc1 + silu(g) * v + the requantization to
    fc2's int8 input is one kernel and fc2 another: the (M, 2H) fc1 output
    and the (M, H) activation are never materialised in float. While
    calibrating (or uncalibrated) the layers run one by one, dynamically.
    """

    def __init__(self, in_features: int, hidden_features: int,
                 out_features: Optional[int] = None, bias: bool = True,
                 quantized: bool = False):
        super().__init__()
        Linear = _linear(quantized)
        self.fc1 = Linear(in_features, 2 * hidden_features, bias=bias)
        self.fc2 = Linear(hidden_features, out_features or in_features,
                          bias=bias)
        self.quantized = quantized

    def forward(self, x: Tensor) -> Tensor:
        if self.quantized:
            p1, p2 = self.fc1.quant_parts(), self.fc2.quant_parts()
            if p1 is not None and p2 is not None:
                xq = quantize_static(x, p1.act_scale).reshape(-1, x.shape[-1])
                mid = swiglu_requant_gemm(xq, p1.w_q, p1.scale, p1.bias,
                                          p2.act_scale_recip)
                y = dequant_gemm(mid, p2.w_q, p2.scale, p2.bias,
                                 self.fc2.weight.dtype)
                return y.reshape(*x.shape[:-1], y.shape[-1])
        g, v = self.fc1(x).chunk(2, dim=-1)
        return self.fc2(F.silu(g) * v)


class Mlp(nn.Module):
    """GELU(tanh) MLP (FiTv1 blocks)."""

    def __init__(self, in_features: int, hidden_features: int,
                 out_features: Optional[int] = None, bias: bool = True,
                 quantized: bool = False):
        super().__init__()
        Linear = _linear(quantized)
        self.fc1 = Linear(in_features, hidden_features, bias=bias)
        self.fc2 = Linear(hidden_features, out_features or in_features,
                          bias=bias)

    def forward(self, x: Tensor) -> Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate='tanh'))


class Attention(nn.Module):
    """Multi-head attention over padded token sequences with 2D RoPE.

    One fused qkv projection; optional per-head q/k norm; RoPE of q/k; the
    mask-aware softmax attention; outputs of padded queries zeroed before
    the output projection.

    ``attn_impl='fused'`` runs q/k norm, RoPE and the attention as one
    kernel off the flat qkv projection where ``fused_attention.supports``
    the configuration (otherwise the unfused path, as in JAX).

    ``save_attention`` keeps each forward's softmax probabilities (B, H, N,
    N) float32 in ``attn_probs`` (eval/attention_viz.py reads them): the
    fp32 logits of the normalised, rotated q and k, scaled by Dh**-0.5,
    -inf on padded keys, then a plain softmax; padded query rows are kept.
    The attention output still comes from the kernels. ``add_rel_pe_to_v``
    rotates v as well as q and k, with plain q/k norms and the interleaved
    layout (the split permutation does not preserve the value basis).

    Under tensor parallelism (parallel/sharding.py) ``qkv`` yields this
    rank's ``num_heads / tp_size`` heads and ``proj`` sums the ranks'
    products. With ``seq`` (a ``parallel.mesh.SequenceShard``) x holds
    this rank's block of the tokens and ``mask`` every token's: q, k and v
    are normed and rotated on the local tokens, exchanged to every token
    of 1/S of the heads (Ulysses), attended with the whole key mask, and
    exchanged back.
    """

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 q_norm: Optional[str] = None, k_norm: Optional[str] = None,
                 qk_norm_weight: bool = False, use_rope: bool = True,
                 add_rel_pe_to_v: bool = False, attn_impl: str = 'auto',
                 save_attention: bool = False, rope_layout: str = 'split',
                 quantized: bool = False):
        super().__init__()
        if attn_impl not in ('auto', 'fused'):
            raise ValueError(f'attn_impl={attn_impl!r}: the port picks the '
                             "attention path by device; use 'auto' or "
                             "'fused'")
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.tp_size = 1
        self.q_norm_type = q_norm
        self.k_norm_type = k_norm
        self.qk_norm_weight = qk_norm_weight
        self.use_rope = use_rope
        self.add_rel_pe_to_v = add_rel_pe_to_v
        self.save_attention = save_attention
        self.attn_probs: Optional[Tensor] = None
        self.rope_layout = 'interleaved' if add_rel_pe_to_v else rope_layout
        Linear = _linear(quantized)
        self.qkv = Linear(dim, 3 * dim, bias=qkv_bias)

        def norm_type(t):
            return 'w_layernorm' if t == 'layernorm' and qk_norm_weight else t

        self.q_norm = LayerNorm(norm_type(q_norm), self.head_dim)
        self.k_norm = LayerNorm(norm_type(k_norm), self.head_dim)
        self.proj = Linear(dim, dim)
        self.fused = attn_impl == 'fused' and fused_attention.supports(
            dim, num_heads, rope_layout, q_norm, k_norm, qk_norm_weight,
            add_rel_pe_to_v, save_attention)
        # fused q/k LN + split RoPE: the hot FiTv2 configuration
        self.fuse_qk = (use_rope and self.rope_layout == 'split'
                        and not add_rel_pe_to_v and not qk_norm_weight
                        and q_norm in (None, 'layernorm')
                        and k_norm in (None, 'layernorm'))
        # no-affine LN on both q and k bounds every row to L2 norm sqrt(Dh),
        # so |logit| <= sqrt(Dh) and the softmax may skip its max pass
        self.bounded = (q_norm == 'layernorm' and k_norm == 'layernorm'
                        and not qk_norm_weight)

    def forward(self, x: Tensor, mask: Optional[Tensor] = None,
                freqs_cos: Optional[Tensor] = None,
                freqs_sin: Optional[Tensor] = None, seq=None) -> Tensor:
        B, N, C = x.shape
        H, Dh = self.num_heads // self.tp_size, self.head_dim
        qkv = self.qkv(x)
        if self.fused and self.use_rope and freqs_cos is not None:
            out = fused_attention.qkln_rope_attention(
                qkv, freqs_cos, freqs_sin, mask, H,
                norm_q=self.q_norm_type == 'layernorm',
                norm_k=self.k_norm_type == 'layernorm')
            return self.proj(out)
        # views of the fused projection: columns [0:C]=q, [C:2C]=k, [2C:3C]=v
        q, k, v = qkv.view(B, N, 3, H, Dh).unbind(2)
        if self.fuse_qk and freqs_cos is not None:
            q, k = qk_norm_rope(q, k, freqs_cos, freqs_sin,
                                norm_q=self.q_norm_type == 'layernorm',
                                norm_k=self.k_norm_type == 'layernorm')
        else:
            q, k = self.q_norm(q), self.k_norm(k)
            if self.use_rope and freqs_cos is not None:
                cos = freqs_cos[:, :, None, :].to(q.dtype)
                sin = freqs_sin[:, :, None, :].to(q.dtype)
                if self.add_rel_pe_to_v:
                    v = apply_rope(v, cos, sin, self.rope_layout)
                q = apply_rope(q, cos, sin, self.rope_layout)
                k = apply_rope(k, cos, sin, self.rope_layout)
        if self.save_attention:
            logits = torch.einsum('bqhd,bkhd->bhqk', q.float(), k.float())
            logits = logits * (Dh ** -0.5)
            if mask is not None:
                logits = logits.masked_fill(
                    ~(mask > 0)[:, None, None, :], float('-inf'))
            self.attn_probs = torch.softmax(logits, dim=-1).detach()
        if seq is not None:
            q, k, v = seq.to_heads(q), seq.to_heads(k), seq.to_heads(v)
        out = masked_attention(q, k, v, mask, bounded_logits=self.bounded)
        if mask is not None:  # zero padded queries
            out = out * mask.to(out.dtype)[..., None, None]
        if seq is not None:
            out = seq.to_tokens(out)
        return self.proj(out.reshape(B, N, H * Dh))


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
            self.mlp = SwiGLU(D, hidden, bias=ffn_bias, quantized=quantized)
        else:
            self.mlp = Mlp(D, mlp_hidden, bias=ffn_bias, quantized=quantized)

    def forward(self, x: Tensor, c: Tensor, mask: Optional[Tensor],
                freqs_cos: Optional[Tensor], freqs_sin: Optional[Tensor],
                global_adaln: Union[Tensor, float] = 0.0,
                seq=None) -> Tensor:
        """``seq``: the token split (``Attention``); x and the RoPE
        tables then hold this rank's tokens, ``mask`` every token."""
        mod = self.adaLN_modulation(c) + global_adaln
        (shift_msa, scale_msa, gate_msa,
         shift_mlp, scale_mlp, gate_mlp) = mod.chunk(6, dim=-1)
        h = norm_modulate(x, shift_msa, scale_msa, self.norm1)
        x = x + _expand_mod(gate_msa, x) * self.attn(h, mask, freqs_cos,
                                                      freqs_sin, seq)
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
