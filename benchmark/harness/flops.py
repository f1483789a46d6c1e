"""The yardstick's arithmetic: the chip's peaks, the operations a FiTv2
forward and an SD-VAE decode need, and the least time a kernel could
take at its shapes.

Peaks: one NVIDIA H100 SXM (the data sheet's dense rates at 700 W): 989
TFLOP/s bf16, 3.35 TB/s HBM. A kernel's bound is the larger of its
operations over the bf16 peak and its bytes, each input read once and
each output written once, over the HBM rate.
"""

from __future__ import annotations

from typing import Dict, Iterable

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def _dims(cfg: Dict) -> Dict[str, int]:
    m = cfg['model']
    D = m['hidden_size']
    mlp = int(D * m['mlp_ratio'])
    hidden = mlp if m.get('use_swiglu_large') else (mlp * 2) // 3
    return dict(D=D, depth=m['depth'], r=m['adaln_lora_dim'], hidden=hidden,
                tok=m['patch_size'] ** 2 * m['in_channels'])


def fit_token_flops(cfg: Dict) -> float:
    """Operations of one token through the forward's per-token products
    (2 per multiply-add): the embedding, each block's qkv, proj and SwiGLU
    fc1 / fc2, the final projection. Attention and the per-sample adaLN
    are apart."""
    d = _dims(cfg)
    D = d['D']
    block = 2 * D * (3 * D + D + 2 * d['hidden']) + 2 * d['hidden'] * D
    return 2 * d['tok'] * D + d['depth'] * block + 2 * D * d['tok']


def fit_sample_flops(cfg: Dict) -> float:
    """Per-sample products: the timestep MLP, the global adaLN, each
    block's rank-r adaLN and the final layer's modulation."""
    d = _dims(cfg)
    D, r = d['D'], d['r']
    return (2 * (256 * D + D * D) + 2 * D * 6 * D
            + d['depth'] * 2 * (D * r + r * 6 * D) + 2 * D * 2 * D)


def fit_forward_flops(cfg: Dict, valid: Iterable[int]) -> float:
    """One forward over samples with these valid token counts: attention
    counted over valid queries and keys (4 n^2 D a block: q k^T and p v)."""
    d = _dims(cfg)
    total = 0.0
    for n in valid:
        total += (n * fit_token_flops(cfg) + fit_sample_flops(cfg)
                  + d['depth'] * 4.0 * n * n * d['D'])
    return total


def vae_decode_flops(vcfg: Dict, lat_h: int, lat_w: int) -> float:
    """One image through the SD-VAE decoder from an (lat_h, lat_w) latent:
    its convolutions (2 Cin Cout k^2 per output pixel) and the mid block's
    attention; norms and activations not counted."""
    ch = list(reversed(vcfg['block_out_channels']))
    lat = vcfg['latent_channels']
    h, w = lat_h, lat_w

    def conv(cin, cout, k, hh, ww):
        return 2.0 * cin * cout * k * k * hh * ww

    f = conv(lat, lat, 1, h, w) + conv(lat, ch[0], 3, h, w)
    f += 2 * 2 * conv(ch[0], ch[0], 3, h, w)            # mid resnets
    hw = h * w
    f += 4 * 2.0 * hw * ch[0] * ch[0] + 2 * 2.0 * hw * hw * ch[0]
    for i, c in enumerate(ch):
        cin = ch[max(i - 1, 0)]
        for j in range(vcfg['layers_per_block']):
            a = cin if j == 0 else c
            f += conv(a, c, 3, h, w) + conv(c, c, 3, h, w)
            if a != c:
                f += conv(a, c, 1, h, w)
        if i < len(ch) - 1:
            h, w = 2 * h, 2 * w
            f += conv(c, c, 3, h, w)
    return f + conv(ch[-1], 3, 3, h, w)


def bound_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def attention_call_bound_s(batch: int, heads: int, n: int, head_dim: int,
                           elem_bytes: int = 2) -> float:
    """K4 on (batch, n, heads, head_dim) q, k, v with every key valid:
    4 n^2 head_dim operations a head; q, k, v read and the output
    written once."""
    flops = 4.0 * batch * heads * n * n * head_dim
    nbytes = 4.0 * batch * n * heads * head_dim * elem_bytes
    return bound_s(flops, nbytes)


def adaln_call_bound_s(batch: int, n: int, dim: int,
                       elem_bytes: int = 2) -> float:
    """K1 on (batch, n, dim) x with (batch, dim) shift and scale: x and the
    output once, shift and scale once."""
    nbytes = elem_bytes * (2.0 * batch * n * dim + 2.0 * batch * dim)
    flops = 8.0 * batch * n * dim
    return bound_s(flops, nbytes)

