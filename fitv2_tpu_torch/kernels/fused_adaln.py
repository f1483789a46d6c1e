"""Fused no-affine LayerNorm + adaLN modulation (csrc/adaln.cu).

``modulate(LN(x), shift, scale)`` runs twice in every FiT block and once in
the final layer. The CUDA kernel reads x once, takes fp32 two-pass moments
and writes the modulated row once in x's dtype. Counterpart of
fitv2_tpu/ops/fused_adaln.py.

Dispatch is by device: a CPU tensor takes the plain version
``adaln_norm_reference``; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from fitv2_tpu_torch.kernels import _build

Tensor = torch.Tensor

_ARGTYPES = (ctypes.c_void_p,) * 4 + (
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p)


def adaln_norm_reference(x: Tensor, shift: Tensor, scale: Tensor,
                         eps: float = 1e-6) -> Tensor:
    """Plain PyTorch version: x (B, N, D); shift/scale (B, D).

    fp32 two-pass moments, ``xhat * (1 + scale) + shift`` in fp32, result in
    x's dtype.
    """
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    xc = x32 - mean
    var = (xc * xc).mean(-1, keepdim=True)
    xhat = xc * torch.rsqrt(var + eps)
    out = xhat * (1.0 + scale.float()[:, None, :]) + shift.float()[:, None, :]
    return out.to(x.dtype)


def fused_adaln_norm(x: Tensor, shift: Tensor, scale: Tensor,
                     eps: float = 1e-6) -> Tensor:
    """Launch the CUDA kernel. x: (B, N, D) contiguous; shift/scale: (B, D)
    with unit column stride (a row stride is allowed)."""
    stream, dtype = _build.stream_and_dtype(x, shift, scale)
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f'x must be a contiguous (B, N, D) tensor, got '
                         f'{tuple(x.shape)} strides {x.stride()}')
    b, n, d = x.shape
    for name, t in (('shift', shift), ('scale', scale)):
        if t.shape != (b, d) or t.stride(1) != 1:
            raise ValueError(f'{name} must be ({b}, {d}) with unit column '
                             f'stride, got {tuple(t.shape)} {t.stride()}')
    if shift.stride(0) != scale.stride(0):
        raise ValueError('shift and scale must share a row stride')
    out = torch.empty_like(x)
    fn = _build.function('fitv2_adaln', _ARGTYPES)
    _build.check(fn(x.data_ptr(), shift.data_ptr(), scale.data_ptr(),
                    out.data_ptr(), b * n, n, d, shift.stride(0), eps, dtype,
                    stream), 'fitv2_adaln')
    fused_adaln_norm.launches += 1
    return out


fused_adaln_norm.launches = 0


def adaln_norm(x: Tensor, shift: Tensor, scale: Tensor,
               eps: float = 1e-6) -> Tensor:
    """modulate(LayerNorm_no_affine(x), shift, scale) for x (B, N, D) and
    (B, D) conditioning: the plain version on the CPU, the kernel on CUDA."""
    if x.device.type == 'cpu':
        return adaln_norm_reference(x, shift, scale, eps)
    return fused_adaln_norm(x, shift, scale, eps)
