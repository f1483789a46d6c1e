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

Each variant has a plain PyTorch version with the same signature:
``attention_reference`` (max-subtracted) and ``attention_bounded_reference``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from fitv2_tpu_torch.kernels import _build
from fitv2_tpu_torch.kernels.fused_qk_rope import _check_heads

Tensor = torch.Tensor

_ARGTYPES = (ctypes.c_void_p,) * 5 + (
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_float,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p)
HEAD_DIMS = (64, 72, 96, 128)  # instantiated in csrc/attention.cu
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


def flash_masked_attention(q: Tensor, k: Tensor, v: Tensor,
                           mask: Optional[Tensor] = None,
                           bounded: bool = False) -> Tensor:
    """Launch the CUDA kernel; returns a contiguous (B, N, H, Dh) tensor.

    q, k, v: (B, N, H, Dh), heads and head dim contiguous, any token stride;
    mask: (B, N), > 0 marks a valid key, or None.
    """
    stream, dtype = _build.stream_and_dtype(q, k, v)
    for name, t in (('q', q), ('k', k), ('v', v)):
        _check_heads(name, t)
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
    return out


flash_masked_attention.launches = 0
