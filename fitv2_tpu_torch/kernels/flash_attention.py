"""Softmax attention with a key-padding mask (csrc/attention.cu).

One CUDA kernel, templated on two compile-time flags, takes the place of two
TPU kernels:

  - ``bounded=False``: online softmax with a running row max, the
    counterpart of fitv2_tpu/ops/flash_attention.py;
  - ``bounded=True``: ``exp(logit)`` with no max pass, the counterpart of
    fitv2_tpu/ops/attention_core.py. Legal only when q and k are both
    no-affine LayerNormed per head, so that ``|logit| <= sqrt(Dh)``.

Padded keys (mask <= 0) get the -1e30 logit; ``mask=None`` means every key
is valid. The output is ``acc / max(l, 1e-20)``. Padded query rows are
computed like any other and zeroed by the caller.

In bf16 the kernel runs on the tensor cores and rounds p to bf16 before
``p @ v``, as both TPU kernels do (the row sum l stays fp32); in fp32 it
keeps every operand in fp32. The bf16 kernel copies rows in 16-byte chunks,
so q, k and v must start on 16 bytes with a token stride of a multiple of 8
elements; the wrapper raises otherwise.

Each variant has a plain PyTorch version with the same signature:
``attention_reference`` (max-subtracted) and ``attention_bounded_reference``.

``FlashMaskedAttention`` gives the kernel a gradient:
``flash_masked_attention_backward`` recomputes the normalised
probabilities in fp32 (padded keys at 0) and applies the softmax-attention
gradients of fitv2_tpu/ops/flash_attention.py's ``_bwd`` (K3), which are
also those of attention_core.py's ``_bwd`` (K4).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from fitv2_tpu_torch.kernels import _build
from fitv2_tpu_torch.kernels._grad import attention_backward
from fitv2_tpu_torch.kernels.fused_qk_rope import _check_heads

Tensor = torch.Tensor

_ARGTYPES = (ctypes.c_void_p,) * 5 + (
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_float,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p)
# instantiated in csrc/attention.cu and csrc/fused_attention.cu
HEAD_DIMS = (32, 64, 72, 96, 128)
MASKED_LOGIT = -1e30


def _logits(q: Tensor, k: Tensor, mask: Optional[Tensor]) -> Tensor:
    """fp32 (B, H, Nq, Nk) scaled logits, padded keys at -1e30."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum('bqhd,bkhd->bhqk', q.float(), k.float()) * scale
    if mask is not None:
        logits = torch.where((mask > 0)[:, None, None, :], logits,
                             torch.full_like(logits, MASKED_LOGIT))
    return logits


def _normalize(p: Tensor, v: Tensor) -> Tensor:
    """(p @ v) / max(rowsum(p), 1e-20) in fp32 -> (B, N, H, Dh) in v's dtype."""
    out = torch.einsum('bhqk,bkhd->bqhd', p, v.float())
    l = p.sum(-1).permute(0, 2, 1)[..., None]  # (B, Nq, H, 1)
    return (out / torch.clamp(l, min=1e-20)).to(v.dtype)


def attention_reference(q: Tensor, k: Tensor, v: Tensor,
                        mask: Optional[Tensor] = None) -> Tensor:
    """Plain max-subtracted softmax attention. q, k, v: (B, N, H, Dh)."""
    logits = _logits(q, k, mask)
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    return _normalize(p, v)


def attention_bounded_reference(q: Tensor, k: Tensor, v: Tensor,
                                mask: Optional[Tensor] = None) -> Tensor:
    """Plain bounded softmax attention: exp(logit) with no max pass."""
    return _normalize(torch.exp(_logits(q, k, mask)), v)


def _check_aligned(name: str, x: Tensor) -> None:
    """The bf16 kernel's 16-byte copies: x must start on 16 bytes and its
    token stride (``x.stride(1)``) must be a multiple of 16 bytes."""
    offset = x.data_ptr() % 16
    stride_bytes = x.stride(1) * x.element_size()
    if offset or stride_bytes % 16:
        raise ValueError(
            f'{name}: the bf16 attention kernel needs rows aligned to 16 '
            f'bytes, got a start {offset} bytes off a 16-byte boundary and a '
            f'token stride of {stride_bytes} bytes')


def flash_masked_attention(q: Tensor, k: Tensor, v: Tensor,
                           mask: Optional[Tensor] = None,
                           bounded: bool = False) -> Tensor:
    """Launch the CUDA kernel; returns a contiguous (B, N, H, Dh) tensor.

    q, k, v: (B, N, H, Dh), heads and head dim contiguous, one token stride
    each (in bf16 aligned to 16 bytes, as are the pointers); mask: (B, N),
    > 0 marks a valid key, or None.
    """
    stream, dtype = _build.stream_and_dtype(q, k, v)
    for name, t in (('q', q), ('k', k), ('v', v)):
        _check_heads(name, t)
        if t.dtype == torch.bfloat16:
            _check_aligned(name, t)
    if not q.shape == k.shape == v.shape:
        raise ValueError(f'q/k/v shapes differ: {tuple(q.shape)} '
                         f'{tuple(k.shape)} {tuple(v.shape)}')
    b, n, h, dh = q.shape
    if dh not in HEAD_DIMS:
        raise ValueError(f'head dim {dh} not instantiated; have {HEAD_DIMS}')
    if mask is not None:
        if mask.shape != (b, n) or mask.device != q.device:
            raise ValueError(f'mask must be ({b}, {n}) on {q.device}, got '
                             f'{tuple(mask.shape)} on {mask.device}')
        mask = mask.to(torch.float32).contiguous()
    out = torch.empty((b, n, h, dh), dtype=q.dtype, device=q.device)
    fn = _build.function('fitv2_attention', _ARGTYPES)
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    None if mask is None else mask.data_ptr(), out.data_ptr(),
                    b, n, h, dh, q.stride(1), k.stride(1), v.stride(1),
                    dh ** -0.5, int(bounded), dtype, stream),
                 'fitv2_attention')
    flash_masked_attention.launches += 1
    flash_masked_attention.bounded_launches += int(bounded)
    return out


# every launch, and those of the bounded variant (K4); the rest are K3
flash_masked_attention.launches = 0
flash_masked_attention.bounded_launches = 0


def attention_probabilities(q: Tensor, k: Tensor, mask: Optional[Tensor],
                            bounded: bool) -> Tensor:
    """fp32 (B, H, Nq, Nk) normalised probabilities as the forward forms
    them: ``e / max(rowsum(e), 1e-20)`` with e = exp(logit) (bounded) or
    exp(logit - rowmax); padded keys get 0 (bounded) or the softmax's
    share of a -1e30 logit."""
    logits = _logits(q, k, mask)
    e = torch.exp(logits if bounded
                  else logits - logits.amax(-1, keepdim=True))
    return e / torch.clamp(e.sum(-1, keepdim=True), min=1e-20)


def flash_masked_attention_backward(q: Tensor, k: Tensor, v: Tensor,
                                    mask: Optional[Tensor], g: Tensor,
                                    bounded: bool = False
                                    ) -> Tuple[Tensor, Tensor, Tensor]:
    """Gradients of the attention for q, k and v given the output's
    gradient g: fp32 softmax gradients from normalised p, cast to the input
    dtypes (dense (B, N, H, Dh), whatever the inputs' strides)."""
    dq, dk, dv = attention_backward(
        attention_probabilities(q, k, mask, bounded), q.float(), k.float(),
        v.float(), g.float(), q.shape[-1] ** -0.5, mask)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class FlashMaskedAttention(torch.autograd.Function):
    """K3/K4 with a gradient. The forward runs ``forward(q, k, v, mask,
    bounded)`` (the kernel's wrapper; a test passes a plain version); the
    backward is ``flash_masked_attention_backward``. The mask gets no
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, mask, bounded, forward):
        ctx.save_for_backward(q, k, v, mask)
        ctx.bounded = bounded
        return forward(q, k, v, mask, bounded)

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask = ctx.saved_tensors
        return (*flash_masked_attention_backward(q, k, v, mask, g,
                                                 ctx.bounded),
                None, None, None)
