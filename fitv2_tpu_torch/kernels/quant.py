"""int8 W8A8 GEMMs: symmetric quantization, the ``Int8Linear`` layer and its
calibration.

Counterpart of fitv2_tpu/ops/quant.py. Weights are quantized per output
channel (absmax over K); activations either per row at run time (the
dynamic mode, which calibration runs) or with one calibrated per-site
scalar scale (the static serving mode, whose GEMMs are the kernels of
``int8_gemm.py``):

  - dynamic: ``q = clip(round(x / s), +-127)`` with ``s = max(absmax, 1e-12)
    / 127`` per row, an exact int32 product (``torch._int_mm``, the plain
    product the JAX package leaves to XLA), ``f32(acc) * s_row * s_col``;
  - static: ``q = clip(round(x * (1 / s)), +-127)`` with the site's
    calibrated ``s`` (a reciprocal multiply, as in JAX), then
    ``int8_gemm_bias`` with the combined ``s * s_col`` vector.

``Int8Linear`` keeps ``nn.Linear``'s ``weight`` and ``bias``, so
checkpoints load unchanged; the int8 weights, the per-channel scales and the
calibrated activation absmax are non-persistent buffers, set by
``prequantize_weights`` / ``calibrate_quant_scales`` or carried over from
the JAX package with ``load_quant_state``. The scale buffers stay float32
when the module is cast to another dtype.
"""

from __future__ import annotations

from typing import Dict, Iterable, NamedTuple, Optional, Tuple

import torch
from torch import nn

from fitv2_tpu_torch.kernels.int8_gemm import dequant_gemm

Tensor = torch.Tensor

QUANT_BUFFERS = ('weight_q', 'w_scale', 'act_absmax')
_FP32_BUFFERS = ('w_scale', 'act_absmax')


class QuantParts(NamedTuple):
    """Serving-mode pieces of a calibrated ``Int8Linear`` (for fusions that
    span two layers, like SwiGLU's fc1 -> fc2)."""
    w_q: Tensor                 # (N, K) int8
    scale: Tensor               # (N,) f32 act_scale * per-channel w_scale
    bias: Optional[Tensor]      # (N,) f32
    act_scale: Tensor           # () f32 calibrated activation scale
    act_scale_recip: float      # 1 / act_scale, rounded to f32


def quantize_symmetric(x: Tensor, axis: int) -> Tuple[Tensor, Tensor]:
    """Absmax int8 quantization along ``axis`` (the contraction axis).

    Returns (q, scale) with x ~= q * scale; scale keeps ``axis`` as 1."""
    x32 = x.float()
    absmax = x32.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp(absmax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127)
    return q.to(torch.int8), scale


def quantize_static(x: Tensor, act_scale: Tensor) -> Tensor:
    """int8 of x with a calibrated scalar scale, by reciprocal multiply."""
    q = torch.round(x.float() * (1.0 / act_scale.float()))
    return torch.clamp(q, -127, 127).to(torch.int8)


def _static_matmul(x: Tensor, w_q: Tensor, scale: Tensor,
                   bias: Optional[Tensor], out_dtype: torch.dtype,
                   act_scale: Tensor) -> Tensor:
    """Static-mode GEMM: quantize x by the scalar act_scale, then the
    dequant GEMM with the combined (N,) scale and an f32 bias."""
    xq = quantize_static(x, act_scale).reshape(-1, x.shape[-1])
    out = dequant_gemm(xq, w_q, scale, bias, out_dtype)
    return out.reshape(*x.shape[:-1], w_q.shape[0])


def int8_matmul(x: Tensor, w_q: Tensor, w_scale: Tensor,
                bias: Optional[Tensor] = None,
                out_dtype: torch.dtype = torch.bfloat16,
                act_scale: Optional[Tensor] = None) -> Tensor:
    """y = x @ dequant(w_q)^T with int8 activations.

    x: (..., K) float; w_q: (N, K) int8; w_scale: (N,) f32. act_scale: a
    calibrated scalar (the static mode, through the kernel on CUDA) or None
    (dynamic per-row scales)."""
    bias32 = None if bias is None else bias.float()
    if act_scale is not None:
        xs = act_scale.float()
        return _static_matmul(x, w_q, xs * w_scale, bias32, out_dtype, xs)
    xq, xs = quantize_symmetric(x.reshape(-1, x.shape[-1]), axis=-1)
    out = torch._int_mm(xq, w_q.t()).float() * xs * w_scale
    if bias32 is not None:
        out = out + bias32
    return out.to(out_dtype).reshape(*x.shape[:-1], w_q.shape[0])


class Int8Linear(nn.Linear):
    """``nn.Linear`` computing through int8 W8A8 GEMMs.

    Without quantized weights bound (``weight_q``), the weight is quantized
    at each call from the dtype it is stored in. Without a calibrated
    ``act_absmax``, activations are quantized per row (dynamic); with one,
    by the site's scalar scale (static, the serving mode). While
    ``calibrating`` is set, each call records the running absmax of its
    whole input and computes dynamically.
    """

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True):
        super().__init__(in_features, out_features, bias=bias)
        for name in QUANT_BUFFERS:
            self.register_buffer(name, None, persistent=False)
        self.calibrating = False
        self._parts: Optional[QuantParts] = None

    def _apply(self, fn, recurse=True):
        # the scale buffers follow device moves but keep float32
        keep = {n: getattr(self, n) for n in _FP32_BUFFERS}
        for n in keep:
            self._buffers[n] = None
        super()._apply(fn, recurse)
        for n, t in keep.items():
            self._buffers[n] = None if t is None else t.to(fn(t).device)
        self._parts = None
        return self

    def set_quant_state(self, **buffers: Optional[Tensor]) -> None:
        """Set some of ``weight_q`` (N, K) int8, ``w_scale`` (N,) and
        ``act_absmax`` () (None clears one) on the layer's device."""
        dev = self.weight.device
        for name, t in buffers.items():
            if name not in QUANT_BUFFERS:
                raise KeyError(f'unknown quantization buffer {name!r}')
            if t is not None:
                t = t.to(device=dev, dtype=torch.int8 if name == 'weight_q'
                         else torch.float32)
            setattr(self, name, t)
        self._parts = None

    def quantized_weight(self) -> Tuple[Tensor, Tensor]:
        """(w_q (N, K) int8, w_scale (N,) f32): bound, or quantized now."""
        if self.weight_q is not None:
            return self.weight_q, self.w_scale
        q, s = quantize_symmetric(self.weight, axis=1)
        return q, s.reshape(-1)

    def quant_parts(self) -> Optional[QuantParts]:
        """The static serving pieces, or None while calibrating or without a
        calibrated scale. Computed once per quantization state."""
        if self.calibrating or self.act_absmax is None:
            return None
        if self._parts is None:
            w_q, w_scale = self.quantized_weight()
            act_scale = torch.clamp(self.act_absmax, min=1e-12) / 127.0
            self._parts = QuantParts(
                w_q, act_scale * w_scale,
                None if self.bias is None else self.bias.float(), act_scale,
                (1.0 / act_scale).item())
        return self._parts

    def forward(self, x: Tensor) -> Tensor:
        parts = self.quant_parts()
        if parts is not None:
            return _static_matmul(x, parts.w_q, parts.scale, parts.bias,
                                  self.weight.dtype, parts.act_scale)
        if self.calibrating:
            amax = x.detach().float().abs().amax()
            self.act_absmax = amax if self.act_absmax is None \
                else torch.maximum(self.act_absmax, amax)
        w_q, w_scale = self.quantized_weight()
        return int8_matmul(x, w_q, w_scale, self.bias,
                           out_dtype=self.weight.dtype)


def int8_layers(model: nn.Module) -> Dict[str, Int8Linear]:
    """Every ``Int8Linear`` of a model by its qualified name."""
    return {name: m for name, m in model.named_modules()
            if isinstance(m, Int8Linear)}


def prequantize_weights(model: nn.Module) -> Dict[str, Tensor]:
    """Quantize every ``Int8Linear`` weight once and bind it; returns the
    bound buffers (``<layer>.weight_q``, ``<layer>.w_scale``)."""
    out = {}
    with torch.no_grad():
        for name, m in int8_layers(model).items():
            m.set_quant_state(weight_q=None, w_scale=None)
            w_q, w_scale = m.quantized_weight()
            m.set_quant_state(weight_q=w_q, w_scale=w_scale)
            out[f'{name}.weight_q'], out[f'{name}.w_scale'] = w_q, w_scale
    return out


def calibrate_quant_scales(model: nn.Module, batches: Iterable[tuple]
                           ) -> Dict[str, Tensor]:
    """Run ``model(*args)`` for each batch in the dynamic mode and bind each
    site's running absmax of its input (over whole tensors and all batches)
    as its calibrated scale. Earlier calibration is discarded. Returns the
    ``<layer>.act_absmax`` buffers."""
    layers = int8_layers(model)
    for m in layers.values():
        m.set_quant_state(act_absmax=None)
        m.calibrating = True
    try:
        with torch.no_grad():
            for args in batches:
                model(*args)
    finally:
        for m in layers.values():
            m.calibrating = False
            m._parts = None
    return {f'{name}.act_absmax': m.act_absmax
            for name, m in layers.items()}


class QuantBinding:
    """One sampler's quantization state of a model whose module other
    samplers share (one a bucket): each ``Int8Linear``'s ``act_absmax`` and
    serving ``QuantParts``, captured once. ``bind()`` puts them back on
    the module before the sampler runs; the parts' reciprocal scales were
    read at capture, so binding costs no host synchronisation."""

    def __init__(self, model: nn.Module):
        self.layers = [(m, m.act_absmax, m.quant_parts())
                       for m in int8_layers(model).values()]

    def bind(self) -> None:
        for m, act_absmax, parts in self.layers:
            m.act_absmax, m._parts = act_absmax, parts


def load_quant_state(model: nn.Module, state: Dict[str, Tensor]) -> None:
    """Bind quantization buffers by qualified name (as returned by
    ``prequantize_weights``, ``calibrate_quant_scales`` or
    ``fitv2_tpu_torch.ckpt.quant_state_from_jax``); every name must match
    a buffer of an ``Int8Linear``."""
    layers = int8_layers(model)
    per_layer: Dict[str, Dict[str, Tensor]] = {}
    for key, t in state.items():
        layer, _, buf = key.rpartition('.')
        if layer not in layers or buf not in QUANT_BUFFERS:
            raise KeyError(f'{key}: no such Int8Linear buffer in the model')
        per_layer.setdefault(layer, {})[buf] = t
    for layer, bufs in per_layer.items():
        layers[layer].set_quant_state(**bufs)
