"""Token-grid, mask and size constructors for full (unpadded) image grids.

Counterpart of fitv2_tpu/models/grid_utils.py: given an image's pixel size,
build the token-grid coordinates, the validity mask and the (n_h, n_w) size
tensor that the FiT forward consumes, padded to a static context length.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def make_grid(n_h: int, n_w: int) -> np.ndarray:
    """(2, N) integer grid; row 0 is the W index, row 1 the H index."""
    gw, gh = np.meshgrid(np.arange(n_w), np.arange(n_h))  # indexing='xy'
    return np.stack([gw.reshape(-1), gh.reshape(-1)], axis=0)


def make_grid_mask_size(batch: int, n_h: int, n_w: int, context_len: int,
                        device: torch.device | str = 'cpu'
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-grid inputs padded to ``context_len``.

    Returns grid (B, 2, L) int64, mask (B, L) float32 and size (B, 1, 2)
    int64, all on ``device``.
    """
    n = n_h * n_w
    if n > context_len:
        raise ValueError(f'grid {n_h}x{n_w} exceeds context {context_len}')
    grid = np.pad(make_grid(n_h, n_w), ((0, 0), (0, context_len - n)))
    mask = np.zeros((context_len,), np.float32)
    mask[:n] = 1.0
    grid_b = torch.as_tensor(grid, dtype=torch.int64).expand(
        batch, 2, context_len)
    mask_b = torch.as_tensor(mask).expand(batch, context_len)
    size_b = torch.tensor([[n_h, n_w]], dtype=torch.int64).expand(batch, 1, 2)
    return (grid_b.contiguous().to(device), mask_b.contiguous().to(device),
            size_b.contiguous().to(device))


def pixels_to_tokens(height: int, width: int, patch_size: int = 2,
                     vae_factor: int = 8) -> Tuple[int, int]:
    """Image pixels -> (n_h, n_w) token-grid dims (latent/patch downsample)."""
    step = patch_size * vae_factor
    if height % step or width % step:
        raise ValueError(f'{height}x{width} is not a multiple of {step}')
    return height // step, width // step
