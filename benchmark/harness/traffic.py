"""The one generator of every traffic mix: reads a mix's parameters
(benchmark/traffic/<name>.json) and makes its inputs from the run's seed,
on the device.

A sampling mix ('kind': 'sample') is batches of class labels, uniform over
the configuration's classes, and standard normal latent noise over the
full token grid of ``image_size``. Every seed does the same work.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from harness.common import INPUTS, derive_seed


def sample_batch(traffic: Dict, cfg: Dict, seed: int, index: int, device
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batch ``index``'s labels (B,) int64 and noise (B, N, p*p*C)
    float32."""
    m = cfg['model']
    p = m['patch_size']
    n = (traffic['image_size'][0] // (8 * p)) * (
        traffic['image_size'][1] // (8 * p))
    gen = torch.Generator(device=device)
    gen.manual_seed(derive_seed(seed, INPUTS, index))
    labels = torch.randint(0, m['num_classes'], (traffic['batch'],),
                           generator=gen, device=device)
    z = torch.randn((traffic['batch'], n, p * p * m['in_channels']),
                    generator=gen, device=device)
    return labels, z
