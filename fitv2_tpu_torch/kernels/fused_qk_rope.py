"""Fused per-head q/k LayerNorm + split-layout RoPE (csrc/qk_rope.cu).

The attention preamble of the FiTv2 block: no-affine LayerNorm of q and k
over the head dim (fp32 statistics, cast back to the input dtype), then the
split-half rotation ``x * cos + [-x[d:], x[:d]] * sin`` in the input dtype,
with the fp32 tables cast to that dtype first. Counterpart of
fitv2_tpu/ops/fused_qk_rope.py.

Dispatch is by device: a CPU tensor takes the plain version
``qk_norm_rope_reference``; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from fitv2_tpu_torch.kernels import _build

Tensor = torch.Tensor

_ARGTYPES = (ctypes.c_void_p,) * 6 + (
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
    ctypes.c_longlong, ctypes.c_float, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p)
MAX_HEAD_DIM = 128  # csrc/qk_rope.cu kMaxDh


def qk_norm_rope_reference(q: Tensor, k: Tensor, cos: Tensor, sin: Tensor,
                           eps: float = 1e-6, norm_q: bool = True,
                           norm_k: bool = True) -> Tuple[Tensor, Tensor]:
    """Plain PyTorch version. q, k: (B, N, H, Dh); cos/sin: (B, N, Dh)."""
    def ln(x):
        x32 = x.float()
        mean = x32.mean(-1, keepdim=True)
        xc = x32 - mean
        var = (xc * xc).mean(-1, keepdim=True)
        return (xc * torch.rsqrt(var + eps)).to(x.dtype)

    def rot(x):
        d = x.shape[-1] // 2
        return torch.cat([-x[..., d:], x[..., :d]], dim=-1)

    c = cos[:, :, None, :].to(q.dtype)
    s = sin[:, :, None, :].to(q.dtype)
    qn = ln(q) if norm_q else q
    kn = ln(k) if norm_k else k
    return qn * c + rot(qn) * s, kn * c + rot(kn) * s


def _check_heads(name: str, x: Tensor) -> None:
    """(B, N, H, Dh) with heads and head dim contiguous and one token stride."""
    if x.dim() != 4:
        raise ValueError(f'{name} must be (B, N, H, Dh), got {tuple(x.shape)}')
    _, n, h, dh = x.shape
    if (x.stride(3) != 1 or x.stride(2) != dh or x.stride(1) < h * dh
            or x.stride(0) != n * x.stride(1)):
        raise ValueError(f'{name}: heads and head dim must be contiguous with '
                         f'a single token stride, got strides {x.stride()}')


def fused_qk_rope(q: Tensor, k: Tensor, cos: Tensor, sin: Tensor,
                  eps: float = 1e-6, norm_q: bool = True,
                  norm_k: bool = True) -> Tuple[Tensor, Tensor]:
    """Launch the CUDA kernel; returns contiguous (B, N, H, Dh) q and k.

    q and k may be column blocks of the fused qkv projection (token stride
    3C); cos/sin must be contiguous float32 (B, N, Dh)."""
    stream, dtype = _build.stream_and_dtype(q, k)
    _check_heads('q', q)
    _check_heads('k', k)
    b, n, h, dh = q.shape
    if k.shape != q.shape:
        raise ValueError(f'q {tuple(q.shape)} and k {tuple(k.shape)} differ')
    if dh % 2 or dh > MAX_HEAD_DIM:
        raise ValueError(f'head dim {dh} must be even and <= {MAX_HEAD_DIM}')
    for name, t in (('cos', cos), ('sin', sin)):
        if (t.shape != (b, n, dh) or t.dtype != torch.float32
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError(f'{name} must be contiguous float32 {(b, n, dh)} '
                             f'on {q.device}, got {tuple(t.shape)} {t.dtype} '
                             f'{t.device}')
    oq = torch.empty((b, n, h, dh), dtype=q.dtype, device=q.device)
    ok = torch.empty_like(oq)
    fn = _build.function('fitv2_qk_rope', _ARGTYPES)
    _build.check(fn(q.data_ptr(), k.data_ptr(), cos.data_ptr(),
                    sin.data_ptr(), oq.data_ptr(), ok.data_ptr(), b * n, h,
                    dh, q.stride(1), k.stride(1), eps, int(norm_q),
                    int(norm_k), dtype, stream), 'fitv2_qk_rope')
    fused_qk_rope.launches += 1
    return oq, ok


fused_qk_rope.launches = 0


def qk_norm_rope(q: Tensor, k: Tensor, cos: Tensor, sin: Tensor,
                 eps: float = 1e-6, norm_q: bool = True, norm_k: bool = True
                 ) -> Tuple[Tensor, Tensor]:
    """Per-head no-affine LN (optional per tensor) + split RoPE: the plain
    version on the CPU, the kernel on CUDA."""
    if q.device.type == 'cpu':
        return qk_norm_rope_reference(q, k, cos, sin, eps, norm_q, norm_k)
    return fused_qk_rope(q, k, cos, sin, eps, norm_q, norm_k)
