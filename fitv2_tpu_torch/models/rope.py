"""2D axial rotary position embeddings with resolution-extrapolation modes.

Counterpart of fitv2_tpu/models/rope.py. Each attention head's dim is split
in half for the H and W axes; the per-axis inverse frequencies follow one of
six modes (``normal``, ``linear``, ``ntk-aware[-pro1/-pro2]``,
``ntk-by-parts``, ``yarn``). Static per-model cos/sin tables are built once
(the post-scale folded in), so a forward pass is two gathers and a concat.

All table math runs in float32, as in the JAX package. The online path
(``online_rope_from_grid``) recomputes the frequencies per sample from each
sample's (h, w) token grid size, on the grid's device; the HR configs
(online decoupled NTK) take it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# NTK / YaRN helper math
# ---------------------------------------------------------------------------

def find_correction_factor(num_rotations: float, dim: int, base: float,
                           max_position_embeddings: int) -> float:
    """Inverse frequency formula: band index that completes `num_rotations`."""
    return (dim * math.log(max_position_embeddings
                           / (num_rotations * 2 * math.pi))) / (
        2 * math.log(base))


def find_correction_range(low_rot: float, high_rot: float, dim: int,
                          base: float, max_position_embeddings: int
                          ) -> Tuple[int, int]:
    low = math.floor(find_correction_factor(low_rot, dim, base,
                                            max_position_embeddings))
    high = math.ceil(find_correction_factor(high_rot, dim, base,
                                            max_position_embeddings))
    return max(low, 0), min(high, dim - 1)


def _linear_ramp(lo: float, hi: float, n: int) -> Tensor:
    if lo == hi:
        hi += 0.001  # prevent singularity
    ramp = (np.arange(n, dtype=np.float32) - lo) / (hi - lo)
    return torch.from_numpy(np.clip(ramp, 0.0, 1.0).astype(np.float32))


def _find_newbase_ntk(dim: int, base, scale):
    return base * scale ** (dim / (dim - 2))


def get_mscale(scale: Tensor) -> Tensor:
    """YaRN magnitude scale; identity for scale <= 1."""
    return torch.where(scale <= 1.0, torch.ones_like(scale),
                       0.1 * torch.log(scale) + 1.0)


def get_proportion(L_test: Tensor, L_train) -> Tensor:
    """Proportional attention scaling."""
    L_test = L_test * 2
    ratio = L_test / L_train
    return torch.where(
        ratio <= 1.0, torch.ones_like(ratio),
        torch.sqrt(torch.log(L_test.to(torch.float32))
                   / torch.log(torch.tensor(float(L_train)))))


def _f32(x) -> Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


# ---------------------------------------------------------------------------
# Frequency ladders
# ---------------------------------------------------------------------------

def get_1d_rope_freqs(mode: str, theta: float, dim: int, max_pe_len,
                      ori_max_pe_len: int) -> Tensor:
    """Per-axis inverse frequencies of shape (..., dim//2), float32.

    ``max_pe_len`` may be a python scalar (static table build) or a (B,)
    tensor (per-sample frequencies).
    """
    mode = mode.lower()
    max_pe_len = _f32(max_pe_len)
    dev = max_pe_len.device
    scale = torch.clamp(max_pe_len / ori_max_pe_len, min=1.0)
    bands = torch.arange(0, dim, 2, dtype=torch.float32,
                         device=dev) / dim  # (dim//2,)
    base_freqs = 1.0 / (theta ** bands)

    if mode == 'normal':
        freqs = base_freqs.expand(scale.shape + bands.shape)
    elif mode == 'linear':
        freqs = 1.0 / (scale[..., None] * theta ** bands)
    elif mode in ('ntk-aware', 'ntk-aware-pro1', 'ntk-aware-pro2'):
        newbase = _find_newbase_ntk(dim, theta, scale)
        freqs = newbase[..., None] ** (-bands)
    elif mode == 'ntk-by-parts':
        beta_0, beta_1, gamma_0, gamma_1 = 1.25, 0.75, 16, 2
        freqs_linear = 1.0 / (scale[..., None] * theta ** bands)
        newbase = _find_newbase_ntk(dim, theta, scale)
        freqs_ntk = newbase[..., None] ** (-bands)
        low, high = find_correction_range(beta_0, beta_1, dim, theta,
                                          ori_max_pe_len)
        m = 1 - _linear_ramp(low, high, dim // 2).to(dev)
        freqs = freqs_linear * (1 - m) + freqs_ntk * m
        low, high = find_correction_range(gamma_0, gamma_1, dim, theta,
                                          ori_max_pe_len)
        m = 1 - _linear_ramp(low, high, dim // 2).to(dev)
        freqs = freqs * (1 - m) + base_freqs * m
    elif mode == 'yarn':
        beta_fast, beta_slow = 32, 1
        freqs_interp = 1.0 / (scale[..., None] * theta ** bands)
        low, high = find_correction_range(beta_fast, beta_slow, dim, theta,
                                          ori_max_pe_len)
        m = 1 - _linear_ramp(low, high, dim // 2).to(dev)
        freqs = freqs_interp * (1 - m) + base_freqs * m
    else:
        raise ValueError(
            f'Unknown rope mode {mode!r}; supported: normal, linear, '
            'ntk-aware[-pro1/2], ntk-by-parts, yarn')
    return freqs


def _post_scale(mode: str, max_pe_len_h, max_pe_len_w,
                ori_max_pe_len) -> Tensor:
    """cos/sin magnitude factor applied after rotation (mscale/proportion)."""
    mode = mode.lower()
    if mode == 'yarn':
        scale = torch.clamp(torch.maximum(_f32(max_pe_len_h),
                                          _f32(max_pe_len_w))
                            / ori_max_pe_len, min=1.0)
        return get_mscale(scale)
    if mode == 'ntk-aware-pro1':
        m = torch.maximum(_f32(max_pe_len_h), _f32(max_pe_len_w))
        return get_proportion(m, ori_max_pe_len)
    if mode == 'ntk-aware-pro2':
        prod = _f32(max_pe_len_h) * _f32(max_pe_len_w)
        return get_proportion(prod, ori_max_pe_len ** 2)
    return _f32(1.0)


# ---------------------------------------------------------------------------
# Rotation application
# ---------------------------------------------------------------------------

def rotate_half(x: Tensor) -> Tensor:
    """Interleaved-pair rotation: (x0, x1, x2, x3, ...) -> (-x1, x0, -x3, x2, ...)."""
    x1 = x[..., 0::2]
    x2 = x[..., 1::2]
    return torch.stack([-x2, x1], dim=-1).reshape(x.shape)


def rotate_half_split(x: Tensor) -> Tensor:
    """Split-half rotation: (a || b) -> (-b || a) with contiguous halves.

    The same rotation as ``rotate_half`` under the head-dim basis
    permutation ``split_permutation``; dot products are invariant when q, k
    and the cos/sin tables all use the permuted basis.
    """
    d = x.shape[-1] // 2
    return torch.cat([-x[..., d:], x[..., :d]], dim=-1)


def apply_rope(x: Tensor, cos: Tensor, sin: Tensor,
               layout: str = 'interleaved') -> Tensor:
    """x * cos + rotate(x) * sin, broadcasting cos/sin over heads."""
    rot = rotate_half_split if layout == 'split' else rotate_half
    return x * cos + rot(x) * sin


def split_permutation(head_dim: int) -> np.ndarray:
    """Old (interleaved) index for each new (split) position:
    [0, 2, ..., D-2, 1, 3, ..., D-1]."""
    return np.concatenate([np.arange(0, head_dim, 2),
                           np.arange(1, head_dim, 2)])


# ---------------------------------------------------------------------------
# Static per-model tables
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RopeConfig:
    head_dim: int
    mode: str = 'normal'
    theta: float = 10000.0
    max_cached_len: int = 256
    max_pe_len_h: Optional[int] = None
    max_pe_len_w: Optional[int] = None
    decouple: bool = False
    ori_max_pe_len: Optional[int] = None
    online: bool = False
    layout: str = 'interleaved'  # 'interleaved' (reference basis) | 'split'

    def __post_init__(self):
        if (self.head_dim // 2) % 2:
            raise ValueError('per-axis rope dim must be even')

    @property
    def axis_dim(self) -> int:
        return self.head_dim // 2


def build_rope_cache(cfg: RopeConfig) -> Dict[str, Tensor]:
    """cos/sin lookup tables per axis, float32 on the CPU, post-scale folded.

    interleaved: (max_cached_len, axis_dim) with each angle repeated twice;
    split: (max_cached_len, axis_dim // 2), assembled [h, w, h, w] by
    ``rope_from_grid``.
    """
    dim = cfg.axis_dim
    mode = cfg.mode.lower()
    if mode == 'normal':
        freqs_h = get_1d_rope_freqs('normal', cfg.theta, dim, 1, 1)
        freqs_w = freqs_h
        scale = _f32(1.0)
    else:
        if cfg.ori_max_pe_len is None:
            raise ValueError('interpolated rope needs ori_max_pe_len')
        if cfg.decouple:
            freqs_h = get_1d_rope_freqs(mode, cfg.theta, dim, cfg.max_pe_len_h,
                                        cfg.ori_max_pe_len)
            freqs_w = get_1d_rope_freqs(mode, cfg.theta, dim, cfg.max_pe_len_w,
                                        cfg.ori_max_pe_len)
        else:
            max_pe = max(cfg.max_pe_len_h, cfg.max_pe_len_w)
            freqs_h = get_1d_rope_freqs(mode, cfg.theta, dim, max_pe,
                                        cfg.ori_max_pe_len)
            freqs_w = freqs_h
        scale = _post_scale(mode, cfg.max_pe_len_h, cfg.max_pe_len_w,
                            cfg.ori_max_pe_len)

    pos = torch.arange(cfg.max_cached_len, dtype=torch.float32)
    ang_h = pos[:, None] * freqs_h.reshape(-1)[None, :]
    ang_w = pos[:, None] * freqs_w.reshape(-1)[None, :]
    if cfg.layout != 'split':
        ang_h = torch.repeat_interleave(ang_h, 2, dim=-1)
        ang_w = torch.repeat_interleave(ang_w, 2, dim=-1)
    return {
        'cos_h': torch.cos(ang_h) * scale,
        'sin_h': torch.sin(ang_h) * scale,
        'cos_w': torch.cos(ang_w) * scale,
        'sin_w': torch.sin(ang_w) * scale,
    }


def rope_from_grid(cache: Dict[str, Tensor], grid: Tensor,
                   layout: str = 'interleaved') -> Tuple[Tensor, Tensor]:
    """Gather cached cos/sin for a token grid.

    grid: (B, 2, N) integer, ``grid[:, 0]`` the W index and ``grid[:, 1]``
    the H index. Returns cos, sin, each (B, N, head_dim) float32 on the
    tables' device: interleaved [H-rep2 || W-rep2], split [H, W, H, W].
    """
    gw = grid[:, 0].long()
    gh = grid[:, 1].long()
    ch, cw = cache['cos_h'][gh], cache['cos_w'][gw]
    sh, sw = cache['sin_h'][gh], cache['sin_w'][gw]
    if layout == 'split':
        return (torch.cat([ch, cw, ch, cw], dim=-1),
                torch.cat([sh, sw, sh, sw], dim=-1))
    return torch.cat([ch, cw], dim=-1), torch.cat([sh, sw], dim=-1)


def rope_21d_from_grid(cache: Dict[str, Tensor], grid: Tensor,
                       layout: str = 'interleaved') -> Tuple[Tensor, Tensor]:
    """2+1D RoPE for video tokens: the time index offsets both spatial
    indices before the 2D table lookup. grid: (B, 3, N) with (w, h, t)
    rows."""
    shifted = torch.stack([grid[:, 0] + grid[:, 2], grid[:, 1] + grid[:, 2]],
                          dim=1)
    return rope_from_grid(cache, shifted, layout)


def online_rope_from_grid(cfg: RopeConfig, grid: Tensor, size: Tensor
                          ) -> Tuple[Tensor, Tensor]:
    """Per-sample frequencies: cos, sin (B, N, head_dim) float32 on grid's
    device, each sample's ladder scaled to its own token grid size.

    grid: (B, 2, N) integer, ``grid[:, 0]`` the W index and ``grid[:, 1]``
    the H index; size: (B, 1, 2) or (B, 2) holding (h, w) per sample. The
    post-scale (mscale / proportion) is applied per sample.
    """
    dim = cfg.axis_dim
    size = size.reshape(size.shape[0], -1)[:, :2].to(device=grid.device,
                                                     dtype=torch.float32)
    size_h, size_w = size[:, 0], size[:, 1]
    if cfg.decouple:
        freqs_h = get_1d_rope_freqs(cfg.mode, cfg.theta, dim, size_h,
                                    cfg.ori_max_pe_len)
        freqs_w = get_1d_rope_freqs(cfg.mode, cfg.theta, dim, size_w,
                                    cfg.ori_max_pe_len)
    else:
        freqs_h = get_1d_rope_freqs(cfg.mode, cfg.theta, dim,
                                    torch.maximum(size_h, size_w),
                                    cfg.ori_max_pe_len)
        freqs_w = freqs_h
    ang_w = grid[:, 0].to(torch.float32)[..., None] * freqs_w[:, None, :]
    ang_h = grid[:, 1].to(torch.float32)[..., None] * freqs_h[:, None, :]
    if cfg.layout == 'split':
        ang = torch.cat([ang_h, ang_w, ang_h, ang_w], dim=-1)
    else:
        ang = torch.cat([torch.repeat_interleave(ang_h, 2, dim=-1),
                         torch.repeat_interleave(ang_w, 2, dim=-1)], dim=-1)
    scale = _post_scale(cfg.mode, size_h, size_w, cfg.ori_max_pe_len)
    scale = (scale * torch.ones_like(size_h)).reshape(-1, 1, 1)
    return torch.cos(ang) * scale, torch.sin(ang) * scale
