"""int8 W8A8 GEMMs with fused epilogues (csrc/int8_gemm_wgmma.cu: K6;
csrc/int8_gemm.cu: K7).

Counterpart of fitv2_tpu/ops/int8_gemm.py, the two kernels of the int8
serving path (calibrated static activation scales):

  - ``int8_gemm_bias``: (M, K) s8 @ (N, K)^T s8 -> s32, then
    ``f32(acc) * scale[N] + bias[N]`` rounded to the output dtype (qkv,
    proj, fc2; fc1 of the GELU Mlp);
  - ``int8_gemm_swiglu_quant``: SwiGLU's fc1 GEMM, dequantization and bias,
    ``silu(g) * v`` in f32 and the requantization
    ``clip(round(h * out_scale_recip), -127, 127)`` to fc2's int8 input.

Weights are in the ``nn.Linear`` layout (N, K), K-contiguous per output
column; the JAX kernels take the flax (K, N) kernel. ``scale`` is the
pre-combined ``act_scale * w_scale`` vector (f32); ``bias`` is f32 or None.

Dispatch is by device (``dequant_gemm``, ``swiglu_requant_gemm``): a CPU
tensor takes the plain version, a CUDA tensor launches the kernel or
raises. The plain versions multiply with ``torch._int_mm`` (exact int32 on
the CPU and on CUDA) and run the same f32 epilogue.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from fitv2_tpu_torch.kernels import _build

Tensor = torch.Tensor

_BIAS_ARGTYPES = (ctypes.c_void_p,) * 5 + (
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)
_SWIGLU_ARGTYPES = (ctypes.c_void_p,) * 5 + (
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p)


def _acc(xq: Tensor, wq: Tensor) -> Tensor:
    """Exact int32 (M, N) product of s8 (M, K) and s8 (N, K)^T."""
    return torch._int_mm(xq, wq.t())


def int8_gemm_bias_reference(xq: Tensor, wq: Tensor, scale: Tensor,
                             bias: Optional[Tensor],
                             out_dtype: torch.dtype = torch.bfloat16
                             ) -> Tensor:
    """Plain version: xq (M, K) s8, wq (N, K) s8, scale/bias (N,) f32."""
    out = _acc(xq, wq).float() * scale.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(out_dtype)


def int8_gemm_swiglu_quant_reference(xq: Tensor, wq: Tensor, scale: Tensor,
                                     bias: Optional[Tensor],
                                     out_scale_recip: float) -> Tensor:
    """Plain version: xq (M, K) s8, wq (2H, K) s8 with rows [0, H) the gate
    and [H, 2H) the value, scale/bias (2H,) f32 -> (M, H) s8."""
    y = int8_gemm_bias_reference(xq, wq, scale, bias, torch.float32)
    g, v = y.chunk(2, dim=-1)
    h = (g * torch.sigmoid(g)) * v
    q = torch.round(h * torch.tensor(out_scale_recip, dtype=torch.float32))
    return torch.clamp(q, -127, 127).to(torch.int8)


def _check_operands(name: str, xq: Tensor, wq: Tensor, scale: Tensor,
                    bias: Optional[Tensor], n_rows: int) -> None:
    """Device, dtype, shape, contiguity and alignment of a GEMM's operands."""
    dev = xq.device
    if dev.type != 'cuda':
        raise ValueError(f'{name}: operands must be CUDA tensors, got {dev}')
    if dev.index != torch.cuda.current_device():
        raise ValueError(f'{name}: operands on {dev} but the current device '
                         f'is cuda:{torch.cuda.current_device()}')
    vecs = [('scale', scale)] + ([] if bias is None else [('bias', bias)])
    for t_name, t in [('xq', xq), ('wq', wq)] + vecs:
        if t.device != dev:
            raise ValueError(f'{name}: {t_name} on {t.device}, xq on {dev}')
        if not t.is_contiguous():
            raise ValueError(f'{name}: {t_name} must be contiguous')
    for t_name, t in (('xq', xq), ('wq', wq)):
        if t.dtype != torch.int8 or t.dim() != 2:
            raise TypeError(f'{name}: {t_name} must be a 2-D int8 tensor, '
                            f'got {t.dtype} {tuple(t.shape)}')
        if t.data_ptr() % 16:
            raise ValueError(f'{name}: {t_name} must be 16-byte aligned')
    m, k = xq.shape
    if wq.shape != (n_rows, k) or k % 16 or not k:
        raise ValueError(f'{name}: need xq (M, K), wq ({n_rows}, K) with '
                         f'K % 16 == 0, K > 0; got {tuple(xq.shape)} '
                         f'{tuple(wq.shape)}')
    for t_name, t in vecs:
        if t.dtype != torch.float32 or t.shape != (n_rows,):
            raise TypeError(f'{name}: {t_name} must be float32 ({n_rows},), '
                            f'got {t.dtype} {tuple(t.shape)}')


def int8_gemm_bias(xq: Tensor, wq: Tensor, scale: Tensor,
                   bias: Optional[Tensor],
                   out_dtype: torch.dtype = torch.bfloat16) -> Tensor:
    """Launch the CUDA kernel: (M, K) s8 @ (N, K)^T s8 -> (M, N) out_dtype
    (float32 or bfloat16)."""
    _check_operands('int8_gemm_bias', xq, wq, scale, bias, wq.shape[0])
    if out_dtype not in _build.DTYPE_CODES:
        raise TypeError(f'int8_gemm_bias: out_dtype must be float32 or '
                        f'bfloat16, got {out_dtype}')
    m, k = xq.shape
    n = wq.shape[0]
    out = torch.empty((m, n), dtype=out_dtype, device=xq.device)
    fn = _build.function('fitv2_int8_gemm_bias', _BIAS_ARGTYPES)
    _build.check(fn(xq.data_ptr(), wq.data_ptr(), scale.data_ptr(),
                    None if bias is None else bias.data_ptr(), out.data_ptr(),
                    m, n, k, _build.DTYPE_CODES[out_dtype],
                    torch.cuda.current_stream().cuda_stream),
                 'fitv2_int8_gemm_bias')
    int8_gemm_bias.launches += 1
    return out


int8_gemm_bias.launches = 0


def int8_gemm_swiglu_quant(xq: Tensor, wq: Tensor, scale: Tensor,
                           bias: Optional[Tensor],
                           out_scale_recip: float) -> Tensor:
    """Launch the CUDA kernel: (M, K) s8 @ fc1 (2H, K)^T s8 -> (M, H) s8."""
    two_h = wq.shape[0]
    if wq.dim() != 2 or two_h % 2:
        raise ValueError(f'int8_gemm_swiglu_quant: wq must be (2H, K), got '
                         f'{tuple(wq.shape)}')
    _check_operands('int8_gemm_swiglu_quant', xq, wq, scale, bias, two_h)
    m, k = xq.shape
    h = two_h // 2
    out = torch.empty((m, h), dtype=torch.int8, device=xq.device)
    fn = _build.function('fitv2_int8_gemm_swiglu_quant', _SWIGLU_ARGTYPES)
    _build.check(fn(xq.data_ptr(), wq.data_ptr(), scale.data_ptr(),
                    None if bias is None else bias.data_ptr(), out.data_ptr(),
                    m, h, k, float(out_scale_recip),
                    torch.cuda.current_stream().cuda_stream),
                 'fitv2_int8_gemm_swiglu_quant')
    int8_gemm_swiglu_quant.launches += 1
    return out


int8_gemm_swiglu_quant.launches = 0


def dequant_gemm(xq: Tensor, wq: Tensor, scale: Tensor,
                 bias: Optional[Tensor],
                 out_dtype: torch.dtype = torch.bfloat16) -> Tensor:
    """int8 GEMM + dequant/bias epilogue: the plain version on the CPU, the
    kernel on CUDA."""
    if xq.device.type == 'cpu':
        return int8_gemm_bias_reference(xq, wq, scale, bias, out_dtype)
    return int8_gemm_bias(xq, wq, scale, bias, out_dtype)


def swiglu_requant_gemm(xq: Tensor, wq: Tensor, scale: Tensor,
                        bias: Optional[Tensor],
                        out_scale_recip: float) -> Tensor:
    """SwiGLU fc1 + silu(g) * v + requant: the plain version on the CPU,
    the kernel on CUDA."""
    if xq.device.type == 'cpu':
        return int8_gemm_swiglu_quant_reference(xq, wq, scale, bias,
                                                out_scale_recip)
    return int8_gemm_swiglu_quant(xq, wq, scale, bias, out_scale_recip)
