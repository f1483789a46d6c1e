"""Attention visualization: capture, rollout, heatmap overlays.

Counterpart of fitv2_tpu/eval/attention_viz.py. A FiT built with
``save_attention=True`` keeps each block's softmax probabilities on its
attention module (``Attention.attn_probs``, (B, H, N, N) float32);
``collect_attention_maps`` reads them in block order and
``run_with_attention`` runs a forward and returns its maps. The rollout,
the heatmap and the overlay are the JAX module's numpy arithmetic; the
overlay's bilinear resize is ``F.interpolate(antialias=True)``, which
equals ``jax.image.resize``'s weights both up and down.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from fitv2_tpu_torch.models.modules import Attention


def collect_attention_maps(model: torch.nn.Module) -> List[np.ndarray]:
    """The last forward's per-block (B, H, N, N) float32 maps, in block
    order (the order ``model.modules()`` visits the attention modules)."""
    maps = [m.attn_probs.cpu().numpy() for m in model.modules()
            if isinstance(m, Attention) and m.attn_probs is not None]
    if not maps:
        raise ValueError('no attention maps: build the model with '
                         'save_attention=True and run a forward')
    return maps


@torch.no_grad()
def run_with_attention(model: torch.nn.Module, *args, **kwargs
                       ) -> Tuple[torch.Tensor, List[np.ndarray]]:
    """(output, attention maps) of one forward of a save_attention=True
    model; maps left by an earlier forward are cleared first."""
    for m in model.modules():
        if isinstance(m, Attention):
            m.attn_probs = None
    out = model(*args, **kwargs)
    return out, collect_attention_maps(model)


def attention_rollout(maps: List[np.ndarray], head_fusion: str = 'mean',
                      discard_ratio: float = 0.0) -> np.ndarray:
    """Recursive rollout A_l = norm(0.5 I + 0.5 fuse(A)) @ A_{l-1}
    (Abnar & Zuidema). maps: per-block (B, H, N, N). Returns (B, N, N)."""
    result: Optional[np.ndarray] = None
    for attn in maps:
        if head_fusion == 'mean':
            fused = attn.mean(axis=1)
        elif head_fusion == 'max':
            fused = attn.max(axis=1)
        elif head_fusion == 'min':
            fused = attn.min(axis=1)
        else:
            raise ValueError(head_fusion)
        if discard_ratio > 0:
            b, n, _ = fused.shape
            flat = fused.reshape(b, -1)
            k = int(flat.shape[1] * discard_ratio)
            if k > 0:
                thresh = np.partition(flat, k, axis=1)[:, k:k + 1]
                flat = np.where(flat < thresh, 0.0, flat)
                fused = flat.reshape(b, n, n)
        eye = np.eye(fused.shape[-1], dtype=fused.dtype)[None]
        a = 0.5 * fused + 0.5 * eye
        a = a / a.sum(axis=-1, keepdims=True)
        result = a if result is None else a @ result
    if result is None:
        raise ValueError('no attention maps')
    return result


def token_heatmap(rollout: np.ndarray, grid_hw: Tuple[int, int],
                  query_index: int = 0) -> np.ndarray:
    """One query row of the rollout reshaped to the (h, w) token grid,
    scaled to a maximum of 1."""
    h, w = grid_hw
    row = rollout[:, query_index, :h * w]
    row = row / (row.max(axis=-1, keepdims=True) + 1e-12)
    return row.reshape(-1, h, w)


def overlay_heatmap(image: np.ndarray, heatmap: np.ndarray,
                    alpha: float = 0.5) -> np.ndarray:
    """Blend a [0, 1] heatmap (h, w), resized bilinearly to the image, onto
    a uint8 HWC image as red heat."""
    ih, iw = image.shape[:2]
    hm = torch.from_numpy(np.asarray(heatmap, np.float32))[None, None]
    hm = F.interpolate(hm, size=(ih, iw), mode='bilinear',
                       align_corners=False, antialias=True)[0, 0].numpy()
    colored = np.zeros((ih, iw, 3), np.float32)
    colored[..., 0] = hm * 255.0  # red channel heat
    out = (1 - alpha) * image.astype(np.float32) + alpha * colored
    return np.clip(out, 0, 255).astype(np.uint8)
