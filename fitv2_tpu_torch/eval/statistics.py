"""Evaluation statistics: FID, sFID, Inception Score, precision/recall.

The port's own copy of fitv2_tpu/eval/statistics.py (numpy, float64 on the
host): activations in, metrics out.

  - FID: Frechet distance between Gaussian fits of pool3 activations
  - sFID: the same distance on the spatial (mixed_6/conv) features
  - Inception Score from softmax probabilities
  - improved precision/recall via k-NN manifold radii

One change from the JAX copy: ``knn_radii`` and ``manifold_membership``
take a block of rows at a time, so no N x N distance matrix lives at once
(at N = 50,000 it would be 20 GB of float64); each row's distances are the
same numbers, so the results equal JAX's.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


def activation_statistics(acts: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(mu, sigma) Gaussian fit of (N, D) activations."""
    mu = np.mean(acts, axis=0)
    sigma = np.cov(acts, rowvar=False)
    return mu, sigma


def _sqrtm_psd(mat: np.ndarray, eps: float = 1e-12) -> np.ndarray:
    """Matrix square root via symmetric eigendecomposition (PSD input)."""
    mat = (mat + mat.T) / 2
    vals, vecs = np.linalg.eigh(mat)
    vals = np.clip(vals, 0, None)
    return (vecs * np.sqrt(vals)) @ vecs.T


def frechet_distance(mu1: np.ndarray, sigma1: np.ndarray, mu2: np.ndarray,
                     sigma2: np.ndarray, eps: float = 1e-6) -> float:
    """FID between two Gaussians (ADM FIDStatistics.frechet_distance)."""
    diff = mu1 - mu2
    # sqrt(sigma1 sigma2) computed stably: s1^(1/2) s2 s1^(1/2) is PSD
    s1_half = _sqrtm_psd(sigma1)
    covmean = _sqrtm_psd(s1_half @ sigma2 @ s1_half)
    tr_covmean = np.trace(covmean)
    if not np.isfinite(tr_covmean):
        offset = np.eye(sigma1.shape[0]) * eps
        s1_half = _sqrtm_psd(sigma1 + offset)
        covmean = _sqrtm_psd(s1_half @ (sigma2 + offset) @ s1_half)
        tr_covmean = np.trace(covmean)
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * tr_covmean)


def fid_from_activations(acts1: np.ndarray, acts2: np.ndarray) -> float:
    mu1, s1 = activation_statistics(acts1)
    mu2, s2 = activation_statistics(acts2)
    return frechet_distance(mu1, s1, mu2, s2)


def inception_score(softmax_probs: np.ndarray, split_size: int = 5000
                    ) -> float:
    """IS = exp(E_x KL(p(y|x) || p(y))) averaged over splits
    (evaluator.py:158-180 semantics)."""
    scores = []
    for i in range(0, len(softmax_probs), split_size):
        part = softmax_probs[i:i + split_size]
        kl = part * (np.log(part + 1e-10)
                     - np.log(np.mean(part, axis=0, keepdims=True) + 1e-10))
        scores.append(np.exp(np.mean(np.sum(kl, axis=1))))
    return float(np.mean(scores))


# ---------------------------------------------------------------------------
# Improved precision / recall (k-NN manifolds, ADM ManifoldEstimator)
# ---------------------------------------------------------------------------

def _pairwise_sq_dists(a: np.ndarray, b: np.ndarray,
                       block: int = 2048) -> np.ndarray:
    """Blocked squared euclidean distances (DistanceBlock equivalent;
    fp64 accumulation for the |x|^2 - 2xy + |y|^2 cancellation)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    out = np.empty((a.shape[0], b.shape[0]), np.float64)
    a_sq = np.sum(a ** 2, axis=1)[:, None]
    for j in range(0, b.shape[0], block):
        bj = b[j:j + block]
        d = a_sq - 2 * a @ bj.T + np.sum(bj ** 2, axis=1)[None]
        out[:, j:j + block] = np.maximum(d, 0)
    return out


def knn_radii(feats: np.ndarray, nhood_size: int = 3,
              block: int = 2048) -> np.ndarray:
    """Per-sample squared distance to the k-th nearest neighbor (excl. self),
    ``block`` rows at a time."""
    feats = np.asarray(feats, np.float64)
    n = feats.shape[0]
    radii = np.empty((n,), np.float64)
    for i in range(0, n, block):
        d = _pairwise_sq_dists(feats[i:i + block], feats, block)
        rows = np.arange(d.shape[0])
        d[rows, i + rows] = np.inf
        radii[i:i + block] = np.partition(d, nhood_size - 1,
                                          axis=1)[:, nhood_size - 1]
    return radii


def manifold_membership(probe: np.ndarray, ref_feats: np.ndarray,
                        ref_radii: np.ndarray, block: int = 2048
                        ) -> np.ndarray:
    """For each probe sample: does it fall inside any reference k-NN ball;
    ``block`` probe rows at a time."""
    probe = np.asarray(probe, np.float64)
    ref_feats = np.asarray(ref_feats, np.float64)
    inside = np.empty((probe.shape[0],), bool)
    for i in range(0, probe.shape[0], block):
        d = _pairwise_sq_dists(probe[i:i + block], ref_feats, block)
        inside[i:i + block] = np.any(d <= ref_radii[None, :], axis=1)
    return inside


def precision_recall(ref_feats: np.ndarray, sample_feats: np.ndarray,
                     nhood_size: int = 3) -> Tuple[float, float]:
    """Improved precision/recall (evaluator.py:239-270 semantics):
    precision = frac(samples inside ref manifold);
    recall = frac(ref inside sample manifold)."""
    ref_radii = knn_radii(ref_feats, nhood_size)
    samp_radii = knn_radii(sample_feats, nhood_size)
    precision = float(np.mean(manifold_membership(
        sample_feats, ref_feats, ref_radii)))
    recall = float(np.mean(manifold_membership(
        ref_feats, sample_feats, samp_radii)))
    return precision, recall


def compute_all_metrics(ref_pool: np.ndarray, ref_spatial: Optional[np.ndarray],
                        sample_pool: np.ndarray,
                        sample_spatial: Optional[np.ndarray],
                        sample_softmax: Optional[np.ndarray]
                        ) -> Dict[str, float]:
    """The full ADM metric set from precomputed activations."""
    out: Dict[str, float] = {}
    out['fid'] = fid_from_activations(ref_pool, sample_pool)
    if ref_spatial is not None and sample_spatial is not None:
        out['sfid'] = fid_from_activations(ref_spatial, sample_spatial)
    if sample_softmax is not None:
        out['inception_score'] = inception_score(sample_softmax)
    prec, rec = precision_recall(ref_pool, sample_pool)
    out['precision'] = prec
    out['recall'] = rec
    return out


def load_reference_statistics(path: str) -> Dict[str, np.ndarray]:
    """Load an ADM reference batch npz (arr_0 images) or stats npz
    (mu/sigma). Returns dict with whichever keys exist."""
    data = np.load(path)
    return {k: data[k] for k in data.files}
