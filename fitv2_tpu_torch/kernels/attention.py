"""Mask-aware attention for padded variable-length token sequences.

The reference attends with a pairwise ``(mask_i == mask_j)`` mask and then
zeroes padded query rows; after that zeroing the result equals key-side
padding masking, which is what this package computes (counterpart of
fitv2_tpu/ops/attention.py). The caller zeroes padded query outputs.
"""

from __future__ import annotations

from typing import Optional

import torch

from fitv2_tpu_torch.kernels._grad import needs_grad
from fitv2_tpu_torch.kernels.flash_attention import (
    FlashMaskedAttention, attention_bounded_reference, attention_reference,
    flash_masked_attention)

Tensor = torch.Tensor


def masked_attention(q: Tensor, k: Tensor, v: Tensor,
                     mask: Optional[Tensor] = None,
                     bounded_logits: bool = False) -> Tensor:
    """Scaled dot-product attention with a key-side padding mask.

    q, k, v: (B, N, H, Dh); mask: (B, N), nonzero = valid, or None for
    "every key valid". bounded_logits: the caller guarantees
    ``|logit| <= sqrt(Dh)`` (q and k both no-affine LayerNormed), which
    allows the softmax without a max pass. Returns (B, N, H, Dh).

    The plain versions run on the CPU; a CUDA tensor goes through the
    kernel (csrc/attention.cu), inside ``FlashMaskedAttention`` where
    autograd records the call.
    """
    if q.device.type == 'cpu':
        ref = attention_bounded_reference if bounded_logits \
            else attention_reference
        return ref(q, k, v, mask)
    if needs_grad(q, k, v):
        return FlashMaskedAttention.apply(q, k, v, mask, bounded_logits,
                                          flash_masked_attention)
    return flash_masked_attention(q, k, v, mask, bounded=bounded_logits)
