"""Fused no-affine LayerNorm + adaLN modulation (csrc/adaln.cu).

``modulate(LN(x), shift, scale)`` runs twice in every FiT block and once in
the final layer. The CUDA kernel reads x once, takes fp32 two-pass moments
and writes the modulated row once in x's dtype. Counterpart of
fitv2_tpu/ops/fused_adaln.py.

The kernel has two instantiations, and ``vector_path`` picks one on the
host: a warp per row with the row in registers and vector loads, for the
model widths ``VECTOR_WIDTHS`` on 4-element boundaries; and a scalar one
for any other width or alignment.

Dispatch is by device: a CPU tensor takes the plain version
``adaln_norm_reference``; a CUDA tensor launches the kernel or raises. Where
autograd records the call, the kernel runs inside ``AdaLNNorm``, whose
backward is ``adaln_norm_backward`` (the vjp of fitv2_tpu/ops/
fused_adaln.py's ``_bwd``, in fp32).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from fitv2_tpu_torch.kernels import _build
from fitv2_tpu_torch.kernels._grad import (
    layernorm_backward, layernorm_stats, needs_grad)

Tensor = torch.Tensor

_ARGTYPES = (ctypes.c_void_p,) * 4 + (
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)
# csrc/adaln.cu adaln_kernel_vec: D = 128 * kVecs, the widths in configs/
VECTOR_WIDTHS = (128, 384, 1152, 2304)


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


def vector_path(x: Tensor, shift: Tensor, scale: Tensor) -> bool:
    """Whether the kernel's vector instantiation takes these operands: D
    one of ``VECTOR_WIDTHS``, and x, shift and scale starting on a
    4-element boundary (8 bytes in bf16, 16 in fp32) with a row stride of
    shift/scale that keeps every row there. Otherwise the scalar
    instantiation runs (a column slice starting at an odd element, say)."""
    vec = 4 * x.element_size()
    return (x.shape[-1] in VECTOR_WIDTHS and shift.stride(0) % 4 == 0
            and all(t.data_ptr() % vec == 0 for t in (x, shift, scale)))


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
                    out.data_ptr(), b * n, n, d, shift.stride(0), eps,
                    int(vector_path(x, shift, scale)), dtype, stream),
                 'fitv2_adaln')
    fused_adaln_norm.launches += 1
    return out


fused_adaln_norm.launches = 0


def adaln_norm_backward(x: Tensor, shift: Tensor, scale: Tensor, g: Tensor,
                        eps: float = 1e-6) -> Tuple[Tensor, Tensor, Tensor]:
    """Gradients of ``adaln_norm`` for x, shift and scale given the output's
    gradient g, in fp32, cast to the input dtypes. shift and scale may be
    strided (B, D) views (the chunks of the adaLN output); their gradients
    are dense (B, D)."""
    xhat, rstd = layernorm_stats(x, eps)
    g32 = g.float()
    dshift = g32.sum(1)
    dscale = (g32 * xhat).sum(1)
    dx = layernorm_backward(g32 * (1.0 + scale.float()[:, None, :]), xhat,
                            rstd)
    return dx.to(x.dtype), dshift.to(shift.dtype), dscale.to(scale.dtype)


class AdaLNNorm(torch.autograd.Function):
    """K1 with a gradient. The forward runs ``forward(x, shift, scale,
    eps)`` (the kernel's wrapper; a test passes the plain version); the
    backward is ``adaln_norm_backward``."""

    @staticmethod
    def forward(ctx, x, shift, scale, eps, forward):
        ctx.save_for_backward(x, shift, scale)
        ctx.eps = eps
        return forward(x, shift, scale, eps)

    @staticmethod
    def backward(ctx, g):
        x, shift, scale = ctx.saved_tensors
        return (*adaln_norm_backward(x, shift, scale, g, ctx.eps), None,
                None)


def adaln_norm(x: Tensor, shift: Tensor, scale: Tensor,
               eps: float = 1e-6) -> Tensor:
    """modulate(LayerNorm_no_affine(x), shift, scale) for x (B, N, D) and
    (B, D) conditioning: the plain version on the CPU, the kernel on CUDA."""
    if x.device.type == 'cpu':
        return adaln_norm_reference(x, shift, scale, eps)
    if needs_grad(x, shift, scale):
        return AdaLNNorm.apply(x, shift, scale, eps, fused_adaln_norm)
    return fused_adaln_norm(x, shift, scale, eps)
