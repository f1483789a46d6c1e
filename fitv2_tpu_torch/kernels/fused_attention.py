"""Fused per-head q/k LayerNorm + split RoPE + masked softmax attention off
the flat qkv projection (csrc/fused_attention.cu).

Counterpart of fitv2_tpu/ops/fused_attention.py, the ``attn_impl='fused'``
path: the kernel reads the (B, N, 3C) qkv-projection output and writes the
(B, N, C) attention output; the wrapper zeroes padded query rows after it.
Its numerics differ from the unfused path's in one rounding: p is
normalised (``e / s``) and rounded to the input dtype before ``p @ v``,
where the unfused kernel divides at the end.

Dispatch is by device (``qkln_rope_attention``): a CPU tensor takes the
plain version ``fused_qkln_rope_attention_reference``; a CUDA tensor
launches the kernel or raises. Where autograd records the call, the kernel
runs inside ``FusedQKLNRopeAttention``, whose backward is
``qkln_rope_attention_backward`` (the vjp of fitv2_tpu/ops/
fused_attention.py's ``_bwd``, in fp32: the gradient of the flat qkv; the
tables get none).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from fitv2_tpu_torch.kernels import _build
from fitv2_tpu_torch.kernels._grad import (
    attention_backward, layernorm_backward, layernorm_stats, needs_grad,
    rope_backward, rotate_half)
from fitv2_tpu_torch.kernels.flash_attention import (
    HEAD_DIMS, _logits, attention_probabilities)
from fitv2_tpu_torch.kernels.fused_qk_rope import qk_norm_rope_reference

Tensor = torch.Tensor

_ARGTYPES = (ctypes.c_void_p,) * 5 + (
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p)


def supports(c: int, num_heads: int, rope_layout: str,
             q_norm: Optional[str], k_norm: Optional[str],
             qk_norm_weight: bool, add_rel_pe_to_v: bool,
             save_attention: bool) -> bool:
    """Static eligibility for the fused path (the FiTv2 hot configuration).

    The JAX gate's semantic clauses only: its CPU-backend clause (on the
    CPU the port runs the plain version, the same math), its 12 MiB VMEM
    budget and its ``n % 8`` sublane tiling are the TPU's; the CUDA kernel
    tiles keys through shared memory for any N and guards the ragged
    edge."""
    return (rope_layout == 'split'
            and not qk_norm_weight and not add_rel_pe_to_v
            and not save_attention
            and q_norm in (None, 'layernorm')
            and k_norm in (None, 'layernorm')
            and (c // num_heads) % 2 == 0)


def fused_qkln_rope_attention_reference(
        qkv: Tensor, cos: Tensor, sin: Tensor, mask: Optional[Tensor],
        num_heads: int, eps: float = 1e-6, norm_q: bool = True,
        norm_k: bool = True) -> Tensor:
    """Plain version. qkv: (B, N, 3C) head-concatenated [q | k | v];
    cos/sin: (B, N, Dh) split-layout tables; mask: (B, N) or None.
    Returns (B, N, C) with padded query rows zeroed."""
    b, n, c3 = qkv.shape
    c = c3 // 3
    q, k, v = (t.reshape(b, n, num_heads, c // num_heads)
               for t in qkv.split(c, dim=-1))
    q, k = qk_norm_rope_reference(q, k, cos, sin, eps, norm_q, norm_k)
    p = torch.softmax(_logits(q, k, mask), dim=-1).to(v.dtype)
    out = torch.einsum('bhqk,bkhd->bqhd', p.float(), v.float()).to(v.dtype)
    out = out.reshape(b, n, c)
    if mask is not None:
        out = out * mask.to(out.dtype)[..., None]
    return out


def fused_qkln_rope_attention(qkv: Tensor, cos: Tensor, sin: Tensor,
                              mask: Optional[Tensor], num_heads: int,
                              eps: float = 1e-6, norm_q: bool = True,
                              norm_k: bool = True) -> Tensor:
    """Launch the CUDA kernel; returns (B, N, C) with padded query rows
    zeroed. qkv: contiguous (B, N, 3C); cos/sin: contiguous float32
    (B, N, Dh); mask: (B, N), > 0 marks a valid token, or None."""
    stream, dtype = _build.stream_and_dtype(qkv)
    if qkv.dim() != 3 or not qkv.is_contiguous() or qkv.shape[-1] % 3:
        raise ValueError(f'qkv must be a contiguous (B, N, 3C) tensor, got '
                         f'{tuple(qkv.shape)} strides {qkv.stride()}')
    for name, t in (('qkv', qkv), ('cos', cos), ('sin', sin)):
        if qkv.dtype == torch.bfloat16 and t.data_ptr() % 16:
            raise ValueError(f'{name}: the bf16 fused attention kernel reads '
                             '16-byte chunks and needs a start on 16 bytes, '
                             f'got {t.data_ptr() % 16} bytes off')
    b, n, c3 = qkv.shape
    c = c3 // 3
    dh = c // num_heads
    if c % num_heads or dh not in HEAD_DIMS:
        raise ValueError(f'C = {c} over {num_heads} heads: head dim {dh} not '
                         f'instantiated; have {HEAD_DIMS}')
    for name, t in (('cos', cos), ('sin', sin)):
        if (t.shape != (b, n, dh) or t.dtype != torch.float32
                or not t.is_contiguous() or t.device != qkv.device):
            raise ValueError(f'{name} must be contiguous float32 {(b, n, dh)} '
                             f'on {qkv.device}, got {tuple(t.shape)} '
                             f'{t.dtype} {t.device}')
    if mask is not None:
        if mask.shape != (b, n) or mask.device != qkv.device:
            raise ValueError(f'mask must be ({b}, {n}) on {qkv.device}, got '
                             f'{tuple(mask.shape)} on {mask.device}')
        mask = mask.to(torch.float32).contiguous()
    out = torch.empty((b, n, c), dtype=qkv.dtype, device=qkv.device)
    fn = _build.function('fitv2_fused_attention', _ARGTYPES)
    _build.check(fn(qkv.data_ptr(), cos.data_ptr(), sin.data_ptr(),
                    None if mask is None else mask.data_ptr(), out.data_ptr(),
                    b, n, num_heads, dh, dh ** -0.5, eps, int(norm_q),
                    int(norm_k), dtype, stream), 'fitv2_fused_attention')
    fused_qkln_rope_attention.launches += 1
    if mask is not None:
        out = out * mask.to(out.dtype)[..., None]  # zero padded query rows
    return out


fused_qkln_rope_attention.launches = 0


def qkln_rope_attention_backward(
        qkv: Tensor, cos: Tensor, sin: Tensor, mask: Optional[Tensor],
        g: Tensor, num_heads: int, eps: float = 1e-6, norm_q: bool = True,
        norm_k: bool = True) -> Tensor:
    """Gradient of ``qkln_rope_attention`` for the flat (B, N, 3C) qkv
    given the output's gradient g, in fp32, cast to qkv's dtype.

    Recomputes the normalised, rotated q and k (rounded to qkv's dtype, as
    the forward feeds them to the attention) and the max-subtracted
    softmax; padded query rows carry no gradient (the forward zeroes
    them); then the attention, RoPE and LayerNorm backward passes."""
    b, n, c3 = qkv.shape
    c = c3 // 3
    dh = c // num_heads
    q, k, v = (t.reshape(b, n, num_heads, dh) for t in qkv.split(c, dim=-1))
    cs = cos[:, :, None, :].to(qkv.dtype).float()
    sn = sin[:, :, None, :].to(qkv.dtype).float()

    def prologue(x, norm):
        stats = layernorm_stats(x, eps) if norm else None
        xn = stats[0].to(x.dtype).float() if norm else x.float()
        return (xn * cs + rotate_half(xn) * sn).to(x.dtype).float(), stats

    qr, q_stats = prologue(q, norm_q)
    kr, k_stats = prologue(k, norm_k)
    g32 = g.float()
    if mask is not None:
        g32 = g32 * mask.float()[..., None]
    dqr, dkr, dv = attention_backward(
        attention_probabilities(qr, kr, mask, bounded=False), qr, kr,
        v.float(), g32.reshape(b, n, num_heads, dh), dh ** -0.5, mask)

    def epilogue(dr, stats):
        dx = rope_backward(dr, cs, sn)
        return layernorm_backward(dx, *stats) if stats else dx

    grads = (epilogue(dqr, q_stats), epilogue(dkr, k_stats), dv)
    return torch.cat([t.reshape(b, n, c) for t in grads], dim=-1
                     ).to(qkv.dtype)


class FusedQKLNRopeAttention(torch.autograd.Function):
    """K5 with a gradient. The forward runs ``forward(qkv, cos, sin, mask,
    num_heads, eps, norm_q, norm_k)`` (the kernel's wrapper; a test passes
    the plain version); the backward is ``qkln_rope_attention_backward``."""

    @staticmethod
    def forward(ctx, qkv, cos, sin, mask, num_heads, eps, norm_q, norm_k,
                forward):
        ctx.save_for_backward(qkv, cos, sin, mask)
        ctx.args = (num_heads, eps, norm_q, norm_k)
        return forward(qkv, cos, sin, mask, num_heads, eps, norm_q, norm_k)

    @staticmethod
    def backward(ctx, g):
        qkv, cos, sin, mask = ctx.saved_tensors
        dqkv = qkln_rope_attention_backward(qkv, cos, sin, mask, g,
                                            *ctx.args)
        return (dqkv,) + (None,) * 8


def qkln_rope_attention(qkv: Tensor, cos: Tensor, sin: Tensor,
                        mask: Optional[Tensor], num_heads: int,
                        eps: float = 1e-6, norm_q: bool = True,
                        norm_k: bool = True) -> Tensor:
    """qk-LN + split RoPE + masked attention from the flat qkv: the plain
    version on the CPU, the kernel on CUDA."""
    if qkv.device.type == 'cpu':
        return fused_qkln_rope_attention_reference(
            qkv, cos, sin, mask, num_heads, eps, norm_q, norm_k)
    if needs_grad(qkv):
        return FusedQKLNRopeAttention.apply(
            qkv, cos, sin, mask, num_heads, eps, norm_q, norm_k,
            fused_qkln_rope_attention)
    return fused_qkln_rope_attention(qkv, cos, sin, mask, num_heads, eps,
                                     norm_q, norm_k)
