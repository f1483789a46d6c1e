"""upfirdn2d: upsample -> FIR filter -> downsample (StyleGAN resampling).

Counterpart of fitv2_tpu/ops/upfirdn2d.py, an XLA op there (one
``lax.conv_general_dilated``, no Pallas kernel), so plain PyTorch here:
zero insertion by (up_x, up_y) to h * up (the ``up - 1`` trailing zeros
included), padding (a negative pad crops), one ``F.conv2d`` of every
channel with the flipped filter, then the stride ``down``. Gradients come
from autograd. NCHW, as in JAX.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def _parse_scaling(scaling) -> Tuple[int, int]:
    if isinstance(scaling, int):
        return scaling, scaling
    sx, sy = scaling
    return int(sx), int(sy)


def _parse_padding(padding) -> Tuple[int, int, int, int]:
    if isinstance(padding, int):
        return padding, padding, padding, padding
    if len(padding) == 2:
        px, py = padding
        return px, px, py, py
    px0, px1, py0, py1 = padding
    return px0, px1, py0, py1


def setup_filter(f, normalize: bool = True, flip_filter: bool = False,
                 gain: float = 1.0, separable: Optional[bool] = None
                 ) -> Tensor:
    """A float32 FIR filter: 1-D taps become their outer product unless
    ``separable`` (default: 1-D with 8 taps or more); normalised to sum 1,
    optionally flipped, times ``gain ** (ndim / 2)``."""
    if f is None:
        f = 1
    f = np.asarray(f, np.float32)
    if f.ndim == 0:
        f = f[None]
    if f.ndim not in (1, 2):
        raise ValueError(f'a filter is 1-D or 2-D, got {f.ndim}-D')
    if separable is None:
        separable = f.ndim == 1 and f.size >= 8
    if f.ndim == 1 and not separable:
        f = np.outer(f, f)
    if normalize:
        f = f / f.sum()
    if flip_filter:
        f = f[::-1] if f.ndim == 1 else f[::-1, ::-1]
    f = f * (gain ** (f.ndim / 2))
    return torch.from_numpy(np.ascontiguousarray(f, np.float32))


def upfirdn2d(x: Tensor, f: Optional[Tensor], up=1, down=1, padding=0,
              flip_filter: bool = False, gain: float = 1.0) -> Tensor:
    """x (B, C, H, W) -> upsampled, filtered by ``f`` (a 1-D filter is
    applied as its outer product), padded / cropped and downsampled."""
    upx, upy = _parse_scaling(up)
    downx, downy = _parse_scaling(down)
    px0, px1, py0, py1 = _parse_padding(padding)
    if f is None:
        f = torch.ones((1, 1), dtype=torch.float32)
    f = f.to(x.device)
    if f.dim() == 1:
        f = torch.outer(f, f)
    f = f * gain
    if not flip_filter:
        f = f.flip((0, 1))  # the filter convolves; conv2d correlates
    b, c, h, w = x.shape
    x = x.reshape(b * c, 1, h, w)
    if upx > 1 or upy > 1:  # zero insertion, trailing zeros included
        z = x.new_zeros(b * c, 1, h * upy, w * upx)
        z[:, :, ::upy, ::upx] = x
        x = z
    x = F.pad(x, (px0, px1, py0, py1))  # negative pads crop
    out = F.conv2d(x, f.to(x.dtype)[None, None], stride=(downy, downx))
    return out.reshape(b, c, out.shape[2], out.shape[3])


def _filter_size(f: Optional[Tensor]) -> Tuple[int, int]:
    return (1, 1) if f is None else (f.shape[0], f.shape[-1])


def upsample2d(x: Tensor, f: Optional[Tensor], up: int = 2,
               padding: int = 0, flip_filter: bool = False,
               gain: float = 1.0) -> Tensor:
    upx, upy = _parse_scaling(up)
    px0, px1, py0, py1 = _parse_padding(padding)
    fh, fw = _filter_size(f)
    p = (px0 + (fw + upx - 1) // 2, px1 + (fw - upx) // 2,
         py0 + (fh + upy - 1) // 2, py1 + (fh - upy) // 2)
    return upfirdn2d(x, f, up=up, padding=p, flip_filter=flip_filter,
                     gain=gain * upx * upy)


def downsample2d(x: Tensor, f: Optional[Tensor], down: int = 2,
                 padding: int = 0, flip_filter: bool = False,
                 gain: float = 1.0) -> Tensor:
    downx, downy = _parse_scaling(down)
    px0, px1, py0, py1 = _parse_padding(padding)
    fh, fw = _filter_size(f)
    p = (px0 + (fw - downx + 1) // 2, px1 + (fw - downx) // 2,
         py0 + (fh - downy + 1) // 2, py1 + (fh - downy) // 2)
    return upfirdn2d(x, f, down=down, padding=p, flip_filter=flip_filter,
                     gain=gain)


def filter2d(x: Tensor, f: Tensor, padding=0, flip_filter: bool = False,
             gain: float = 1.0) -> Tensor:
    px0, px1, py0, py1 = _parse_padding(padding)
    fh, fw = _filter_size(f)
    p = (px0 + fw // 2, px1 + (fw - 1) // 2,
         py0 + fh // 2, py1 + (fh - 1) // 2)
    return upfirdn2d(x, f, padding=p, flip_filter=flip_filter, gain=gain)
