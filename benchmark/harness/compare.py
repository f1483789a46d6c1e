"""The numbers that decide ``correct``: each is a gap between what the
program produced and what the plain reference computes from the same
inputs, and each has a limit (benchmark/limits/<workload>.json)."""

from __future__ import annotations

from typing import Dict

import numpy as np


def image_gaps(program: np.ndarray, reference: np.ndarray, patch: int
               ) -> Dict[str, float]:
    """uint8 images (R, H, W, 3): the mean |difference| in levels over every
    pixel and channel (``pixel_gap_mean``), and the largest mean |difference|
    over one token's footprint of ``patch`` x ``patch`` pixels in one image
    (``patch_gap_max``)."""
    if program.shape != reference.shape:
        raise ValueError(f'shapes differ: {program.shape} against '
                         f'{reference.shape}')
    d = np.abs(program.astype(np.int32) - reference.astype(np.int32))
    R, H, W, C = d.shape
    tiles = d.reshape(R, H // patch, patch, W // patch, patch, C)
    return dict(pixel_gap_mean=float(d.mean()),
                patch_gap_max=float(tiles.mean(axis=(2, 4, 5)).max()))
