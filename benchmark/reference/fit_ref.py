"""Plain float32 FiTv2 in PyTorch, written from the model's equations.

The yardstick that the benchmark holds the port's outputs to: no kernel,
no cache, no batching trick, nothing imported from the program. Weights
come in as a dict by the port's parameter names (``param_specs``), the
layout of the published checkpoints after the port's conversion.

The model (FiTv2, arXiv 2410.13925, the configs' network_config): patch
embedding of p*p*C latent patches; a sinusoidal timestep MLP and a label
table whose last row is the null class; a global adaLN term plus a rank-r
adaLN per block (adaLN-LoRA); each block LayerNorm (no affine, eps 1e-6)
+ shift / scale, attention with a fused qkv projection, LayerNorm on q
and k per head, 2-D RoPE (the port's split layout: the head dim's halves
rotate as pairs (i, i + Dh/2), the H axis' frequencies then the W axis'),
softmax over valid keys, padded queries zeroed, a gated residual; then
LayerNorm + shift / scale and a SwiGLU MLP (fc1's outputs [g | v]), gated;
a final modulated projection, padded tokens zeroed. RoPE frequencies: the
normal ladder, or online NTK-aware per sample (each axis scaled by its own
token count over ``ori_max_pe_len``, decoupled).

``lowp=True`` computes it one precision below bf16, in float8
(reference/lowp.py): the control.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from reference.lowp import fp8 as fp8_round

Tensor = torch.Tensor
Spec = Tuple[str, Tuple[int, ...], float, float]  # name, shape, std, mean

# seeded weights: N(mean, std); std = gain / sqrt(fan_in) for a weight
GAIN = 1.0
GAIN_OUT = 0.5      # adaLN outputs and the final projection (zero at init)
STD_EMBED = 0.5     # label table rows: conditioning of order one
STD_BIAS = 0.02


def dims(cfg: Dict) -> Dict[str, int]:
    m = cfg['model']
    D = m['hidden_size']
    mlp = int(D * m['mlp_ratio'])
    hidden = mlp if m.get('use_swiglu_large') else (mlp * 2) // 3
    return dict(D=D, H=m['num_heads'], Dh=D // m['num_heads'],
                depth=m['depth'], p=m['patch_size'], C=m['in_channels'],
                tok=m['patch_size'] ** 2 * m['in_channels'], hidden=hidden,
                r=m['adaln_lora_dim'], classes=m['num_classes'],
                rows=m['num_classes'] + int(m['class_dropout_prob'] > 0))


def param_specs(cfg: Dict) -> List[Spec]:
    """Every parameter of the FiTv2 of ``cfg``: name, shape, std, mean."""
    d = dims(cfg)
    D, r, hidden, tok = d['D'], d['r'], d['hidden'], d['tok']
    specs: List[Spec] = []

    def linear(name, out_f, in_f, gain=GAIN):
        specs.append((f'{name}.weight', (out_f, in_f),
                      gain / math.sqrt(in_f), 0.0))
        specs.append((f'{name}.bias', (out_f,), STD_BIAS, 0.0))

    linear('x_embedder.proj', D, tok)
    linear('t_embedder.mlp_0', D, 256)
    linear('t_embedder.mlp_2', D, D)
    specs.append(('y_embedder.embedding_table', (d['rows'], D), STD_EMBED,
                  0.0))
    linear('global_adaLN_modulation.fc_out', 6 * D, D, GAIN_OUT)
    for i in range(d['depth']):
        b = f'blocks.{i}'
        linear(f'{b}.adaLN_modulation.fc1', r, D)
        linear(f'{b}.adaLN_modulation.fc_out', 6 * D, r, GAIN_OUT)
        linear(f'{b}.attn.qkv', 3 * D, D)
        linear(f'{b}.attn.proj', D, D)
        linear(f'{b}.mlp.fc1', 2 * hidden, D)
        linear(f'{b}.mlp.fc2', D, hidden)
    linear('final_layer.adaLN_modulation.fc_out', 2 * D, D, GAIN_OUT)
    linear('final_layer.linear', tok, D, GAIN_OUT)
    return specs


def _linear(x: Tensor, P: Dict[str, Tensor], name: str, lowp: bool) -> Tensor:
    w, b = P[f'{name}.weight'], P[f'{name}.bias']
    if lowp:
        return fp8_round(fp8_round(x) @ fp8_round(w).t() + b)
    return x @ w.t() + b


def layer_norm(x: Tensor, eps: float = 1e-6) -> Tensor:
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps)


def rope_tables(cfg: Dict, grid: Tensor, size: Tensor) -> Tuple[Tensor, Tensor]:
    """cos, sin (B, N, Dh) in the split layout [h, w, h, w]. grid (B, 2, N):
    row 0 the W index, row 1 the H index; size (B, 1, 2) the (h, w) token
    counts, read by online RoPE."""
    m = cfg['model']
    Dh = m['hidden_size'] // m['num_heads']
    axis = Dh // 2
    theta = float(m.get('rope_theta', 10000.0))
    bands = torch.arange(0, axis, 2, dtype=torch.float32,
                         device=grid.device) / axis
    B = grid.shape[0]
    if m.get('online_rope'):
        if m.get('custom_freqs') != 'ntk-aware' or not m.get('decouple'):
            raise NotImplementedError('reference: online RoPE is the '
                                      'decoupled NTK-aware mode')
        hw = size.reshape(B, 2).float()
        scale = torch.clamp(hw / float(m['ori_max_pe_len']), min=1.0)
        base = theta * scale ** (axis / (axis - 2))      # (B, 2)
        freqs = base[..., None] ** (-bands)              # (B, 2, axis/2)
        f_h, f_w = freqs[:, 0], freqs[:, 1]
    else:
        if m.get('custom_freqs', 'normal') != 'normal':
            raise NotImplementedError('reference: cached RoPE is normal')
        f = 1.0 / (theta ** bands)
        f_h = f_w = f.expand(B, -1)
    ang_h = grid[:, 1].float()[..., None] * f_h[:, None, :]
    ang_w = grid[:, 0].float()[..., None] * f_w[:, None, :]
    ang = torch.cat([ang_h, ang_w, ang_h, ang_w], dim=-1)
    return torch.cos(ang), torch.sin(ang)


def _rotate(x: Tensor, cos: Tensor, sin: Tensor) -> Tensor:
    d = x.shape[-1] // 2
    rot = torch.cat([-x[..., d:], x[..., :d]], dim=-1)
    return x * cos + rot * sin


def timestep_embedding(t: Tensor, dim: int = 256) -> Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def forward(P: Dict[str, Tensor], cfg: Dict, x: Tensor, t: Tensor,
            y: Tensor, grid: Tensor, mask: Optional[Tensor],
            size: Tensor, lowp: bool = False) -> Tensor:
    """x (B, N, p*p*C) float32, t (B,), y (B,) class ids (the null class is
    ``num_classes``), grid (B, 2, N), mask (B, N) 1 = valid or None (every
    token valid), size (B, 1, 2). Returns (B, N, p*p*C) float32.

    With ``lowp`` every tensor that a bf16 program holds in its compute
    dtype (each product's operands and output, the residual stream, the
    modulated norms, q and k after RoPE, the attention's probabilities and
    output, the SwiGLU product) is rounded to float8; norm statistics
    and the softmax stay float32, as they do in bf16."""
    d = dims(cfg)
    B, N, _ = x.shape
    H, Dh, D = d['H'], d['Dh'], d['D']
    q8 = fp8_round if lowp else (lambda v: v)
    t = torch.clamp(t.float(), max=1.0)
    h = _linear(x.float(), P, 'x_embedder.proj', lowp)
    te = _linear(timestep_embedding(t), P, 't_embedder.mlp_0', lowp)
    te = _linear(F.silu(te), P, 't_embedder.mlp_2', lowp)
    c = q8(te + P['y_embedder.embedding_table'][y.long()])
    cos, sin = rope_tables(cfg, grid, size)
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    glob = _linear(F.silu(c), P, 'global_adaLN_modulation.fc_out', lowp)
    keep = None if mask is None else (mask > 0)
    for i in range(d['depth']):
        b = f'blocks.{i}'
        mod = q8(_linear(_linear(F.silu(c), P, f'{b}.adaLN_modulation.fc1',
                                 lowp), P, f'{b}.adaLN_modulation.fc_out',
                         lowp) + glob)
        sh1, sc1, g1, sh2, sc2, g2 = (m[:, None, :] for m in
                                      mod.chunk(6, dim=-1))
        a = q8(layer_norm(h) * (1 + sc1) + sh1)
        qkv = _linear(a, P, f'{b}.attn.qkv', lowp).view(B, N, 3, H, Dh)
        q, k, v = qkv.unbind(2)
        q = q8(_rotate(layer_norm(q), cos, sin))
        k = q8(_rotate(layer_norm(k), cos, sin))
        logits = torch.einsum('bqhd,bkhd->bhqk', q, k) / math.sqrt(Dh)
        if keep is not None:
            logits = logits.masked_fill(~keep[:, None, None, :],
                                        float('-inf'))
        o = q8(torch.einsum('bhqk,bkhd->bqhd',
                            q8(torch.softmax(logits, -1)), v))
        if keep is not None:
            o = o * keep[:, :, None, None].float()
        h = q8(h + g1 * _linear(o.reshape(B, N, D), P, f'{b}.attn.proj',
                                lowp))
        a = q8(layer_norm(h) * (1 + sc2) + sh2)
        gv = _linear(a, P, f'{b}.mlp.fc1', lowp)
        g, v2 = gv.chunk(2, dim=-1)
        h = q8(h + g2 * _linear(q8(F.silu(g) * v2), P, f'{b}.mlp.fc2',
                                lowp))
    shift, scale = _linear(F.silu(c), P, 'final_layer.adaLN_modulation.fc_out',
                           lowp).chunk(2, dim=-1)
    out = _linear(q8(layer_norm(h) * (1 + scale[:, None]) + shift[:, None]),
                  P, 'final_layer.linear', lowp)
    if keep is not None:
        out = out * keep[..., None].float()
    return out


def euler_ladder(steps: int) -> np.ndarray:
    """The (steps + 1,) float32 ladder 0 .. 1: i * f32(1 / steps), the last
    entry exactly 1."""
    ladder = np.arange(steps + 1, dtype=np.float32) * (
        np.float32(1) / np.float32(steps))
    ladder[-1] = 1.0
    return ladder


def sample_cfg(P: Dict[str, Tensor], cfg: Dict, z: Tensor, labels: Tensor,
               grid: Tensor, size: Tensor, steps: int, cfg_scale: float,
               lowp: bool = False) -> Tensor:
    """The flow ODE by Euler from t = 0 (noise z, (B, N, p*p*C)) to t = 1,
    with classifier-free guidance at every step: the velocity
    ``u + s * (c - u)`` of the conditional and null-class outputs, every
    channel. grid and size are (2B, ...). Returns the final state."""
    null = torch.full_like(labels, cfg['model']['num_classes'])
    y = torch.cat([labels, null])
    sig = euler_ladder(steps)
    x = z.float()
    for t0, t1 in zip(sig[:-1], sig[1:]):
        t = torch.full((2 * x.shape[0],), float(t0), device=x.device)
        out = forward(P, cfg, torch.cat([x, x]), t, y, grid, None, size, lowp)
        cond, uncond = out.chunk(2)
        x = x + float(t1 - t0) * (uncond + cfg_scale * (cond - uncond))
    return x


def full_grid(n_h: int, n_w: int, batch: int, device) -> Tensor:
    """(batch, 2, n_h * n_w) token coordinates of a full grid, row-major
    over (h, w): row 0 the W index, row 1 the H index."""
    gh, gw = torch.meshgrid(torch.arange(n_h, device=device),
                            torch.arange(n_w, device=device), indexing='ij')
    grid = torch.stack([gw.reshape(-1), gh.reshape(-1)])
    return grid[None].expand(batch, 2, n_h * n_w)


def unpatchify(x: Tensor, n_h: int, n_w: int, p: int, C: int) -> Tensor:
    """(B, n_h * n_w, C * p * p) tokens, channel-major within a token ->
    (B, p * n_h, p * n_w, C) latents."""
    B = x.shape[0]
    x = x.reshape(B, n_h, n_w, C, p, p)
    return torch.einsum('bhwcpq->bhpwqc', x).reshape(B, n_h * p, n_w * p, C)
