"""Gradient arithmetic shared by the kernels' autograd Functions.

None of the JAX package's kernels has a backward kernel: each ``custom_vjp``
backward runs in XLA, as the vjp of its reference chain or as explicit
softmax-gradient formulas. The port's backward passes are the same
formulas in PyTorch tensor code, in fp32, cast to the input dtypes at the
end. Forward activations the formulas need (LayerNorm statistics, softmax
probabilities) are recomputed here from the saved inputs, as JAX recomputes
them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

Tensor = torch.Tensor


def needs_grad(*tensors) -> bool:
    """Whether autograd records this call: grad mode on and an input that
    requires a gradient. Otherwise the kernel runs bare (the sampler)."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def layernorm_stats(x: Tensor, eps: float) -> Tuple[Tensor, Tensor]:
    """fp32 (xhat, rstd) of a no-affine LayerNorm over the last dim, with
    two-pass moments."""
    x32 = x.float()
    xc = x32 - x32.mean(-1, keepdim=True)
    rstd = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)
    return xc * rstd, rstd


def layernorm_backward(dy: Tensor, xhat: Tensor, rstd: Tensor) -> Tensor:
    """dL/dx of ``xhat = (x - mean) * rstd`` given dL/dxhat, all fp32."""
    return rstd * (dy - dy.mean(-1, keepdim=True)
                   - xhat * (dy * xhat).mean(-1, keepdim=True))


def rotate_half(x: Tensor) -> Tensor:
    """The split-layout RoPE rotation ``[-x[d:], x[:d]]``."""
    d = x.shape[-1] // 2
    return torch.cat([-x[..., d:], x[..., :d]], dim=-1)


def rope_backward(g: Tensor, cos: Tensor, sin: Tensor) -> Tensor:
    """dL/dx of ``x * cos + rotate_half(x) * sin``: ``g * cos`` plus the
    transpose of the rotation, ``[y[d:], -y[:d]]``, applied to ``g * sin``."""
    gs = g * sin
    d = g.shape[-1] // 2
    return g * cos + torch.cat([gs[..., d:], -gs[..., :d]], dim=-1)


def attention_backward(p: Tensor, q: Tensor, k: Tensor, v: Tensor,
                       g: Tensor, scale: float, mask: Optional[Tensor] = None
                       ) -> Tuple[Tensor, Tensor, Tensor]:
    """The softmax-attention gradients from normalised probabilities, in
    the order of fitv2_tpu/ops/flash_attention.py's ``_bwd``.

    p: fp32 (B, H, Nq, Nk); q, k, v, g: fp32 (B, N, H, Dh); mask: (B, Nk),
    > 0 marks a valid key, or None. A padded key's logit is the constant
    -1e30, so its logit gradient is 0: this differs from JAX's formula only
    in a row with no valid key, where the softmax of constants is uniform
    and that formula would pass a gradient on to q and k. Returns fp32
    (dq, dk, dv)."""
    dv = torch.einsum('bhqk,bqhd->bkhd', p, g)
    dp = torch.einsum('bqhd,bkhd->bhqk', g, v)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    if mask is not None:
        ds = ds * (mask > 0)[:, None, None, :]
    dq = torch.einsum('bhqk,bkhd->bqhd', ds, k) * scale
    dk = torch.einsum('bhqk,bqhd->bkhd', ds, q) * scale
    return dq, dk, dv
