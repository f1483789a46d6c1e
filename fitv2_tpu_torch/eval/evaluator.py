"""ADM-style Evaluator: npz batches in, FID/sFID/IS/precision/recall out.

Counterpart of fitv2_tpu/eval/evaluator.py over this package's
``inception`` (activations on the card, or on the CPU when asked) and
``statistics`` (numpy on the host).
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional

import numpy as np
import torch

from fitv2_tpu_torch.eval import statistics as stats
from fitv2_tpu_torch.eval.inception import compute_activations, load_inception

# The published FiTv2 FID numbers come from the ADM suite's TF1 InceptionV3
# graph. This evaluator has its architecture and statistics, but unless
# `inception_weights` is a converted copy of those weights, its FID is
# comparable across runs of this pipeline only.
FID_COMPARABILITY_NOTE = (
    'FID computed with non-ADM Inception weights: comparable across this '
    'pipeline only, not to published FiTv2 numbers (pass the converted ADM '
    'TF-Inception weights for cross-paper comparability).')


class Evaluator:
    def __init__(self, inception_weights: Optional[str] = None,
                 batch_size: int = 64, weights_are_adm: bool = False,
                 device: torch.device | str = 'cuda'):
        """``weights_are_adm`` attests that ``inception_weights`` is a
        converted copy of the ADM suite's TF1 InceptionV3 weights; supplying
        some weights file alone does not make FID comparable to published
        numbers. Without weights the network is a seeded initialisation.
        ``device`` 'cuda' needs a card."""
        self.model = load_inception(inception_weights, device)
        self.batch_size = batch_size
        self.comparable_to_published = (inception_weights is not None
                                        and weights_are_adm)
        if not self.comparable_to_published:
            logging.getLogger(__name__).warning(FID_COMPARABILITY_NOTE)

    def read_activations(self, images_or_npz) -> Dict[str, np.ndarray]:
        """uint8 (N, H, W, 3) images, or the path of an npz with arr_0."""
        if isinstance(images_or_npz, str):
            images = np.load(images_or_npz)['arr_0']
        else:
            images = images_or_npz
        return compute_activations(self.model, images, self.batch_size)

    def compute_statistics(self, acts: Dict[str, np.ndarray]
                           ) -> Dict[str, np.ndarray]:
        mu, sigma = stats.activation_statistics(acts['pool3'])
        mu_s, sigma_s = stats.activation_statistics(acts['spatial'])
        return {'mu': mu, 'sigma': sigma, 'mu_s': mu_s, 'sigma_s': sigma_s}

    def compute_all(self, ref_batch, sample_batch) -> Dict[str, float]:
        ref = self.read_activations(ref_batch)
        samp = self.read_activations(sample_batch)
        return stats.compute_all_metrics(
            ref['pool3'], ref['spatial'], samp['pool3'], samp['spatial'],
            samp['softmax'])


def create_npz_from_sample_folder(sample_dir: str, num: int = 50_000
                                  ) -> str:
    """A folder of {i:06d}.png samples -> ADM npz (arr_0) beside it."""
    from PIL import Image
    samples = [np.asarray(Image.open(os.path.join(
        sample_dir, f'{i:06d}.png'))).astype(np.uint8) for i in range(num)]
    npz_path = f'{sample_dir}.npz'
    np.savez(npz_path, arr_0=np.stack(samples))
    return npz_path
