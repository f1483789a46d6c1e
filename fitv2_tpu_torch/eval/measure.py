"""Frequency-domain and perceptual image statistics, in numpy: the
high-frequency energy ratio, spectral entropy, gradient magnitude, total
variance, SSIM and the mutual information of two images.

The port's own copy of fitv2_tpu/eval/measure.py (pure numpy).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _to_gray(img: np.ndarray) -> np.ndarray:
    """(H, W, C) or (H, W) -> grayscale float64."""
    img = np.asarray(img, np.float64)
    if img.ndim == 3:
        img = img.mean(axis=-1)
    return img


def high_frequency_ratio(img: np.ndarray, cutoff: float = 0.25) -> float:
    """Energy fraction above ``cutoff`` * Nyquist in the 2D spectrum."""
    g = _to_gray(img)
    f = np.fft.fftshift(np.fft.fft2(g))
    power = np.abs(f) ** 2
    h, w = g.shape
    yy, xx = np.mgrid[:h, :w]
    r = np.sqrt(((yy - h / 2) / (h / 2)) ** 2 + ((xx - w / 2) / (w / 2)) ** 2)
    hf = power[r > cutoff].sum()
    return float(hf / (power.sum() + 1e-12))


def spectral_entropy(img: np.ndarray) -> float:
    g = _to_gray(img)
    power = np.abs(np.fft.fft2(g)) ** 2
    p = power / (power.sum() + 1e-12)
    p = p[p > 0]
    return float(-(p * np.log2(p)).sum())


def gradient_magnitude(img: np.ndarray) -> float:
    g = _to_gray(img)
    gy, gx = np.gradient(g)
    return float(np.mean(np.sqrt(gx ** 2 + gy ** 2)))


def total_variance(img: np.ndarray) -> float:
    return float(np.var(_to_gray(img)))


def ssim(img1: np.ndarray, img2: np.ndarray, data_range: float = 255.0,
         window: int = 7) -> float:
    """Mean SSIM with a uniform window (reference uses skimage defaults)."""
    a = _to_gray(img1)
    b = _to_gray(img2)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2

    def box(x):
        k = window
        csum = np.cumsum(np.cumsum(np.pad(x, ((1, 0), (1, 0))), 0), 1)
        out = (csum[k:, k:] - csum[:-k, k:] - csum[k:, :-k] + csum[:-k, :-k])
        return out / (k * k)

    mu_a, mu_b = box(a), box(b)
    var_a = box(a * a) - mu_a ** 2
    var_b = box(b * b) - mu_b ** 2
    cov = box(a * b) - mu_a * mu_b
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a ** 2 + mu_b ** 2 + c1) * (var_a + var_b + c2))
    return float(np.mean(s))


def mutual_information(img1: np.ndarray, img2: np.ndarray,
                       bins: int = 64) -> float:
    a = _to_gray(img1).ravel()
    b = _to_gray(img2).ravel()
    hist, _, _ = np.histogram2d(a, b, bins=bins)
    pxy = hist / hist.sum()
    px = pxy.sum(axis=1, keepdims=True)
    py = pxy.sum(axis=0, keepdims=True)
    nz = pxy > 0
    return float((pxy[nz] * np.log(pxy[nz] / (px @ py)[nz])).sum())


def measure_all(img: np.ndarray, ref: np.ndarray = None) -> dict:
    out = {
        'hf_ratio': high_frequency_ratio(img),
        'spectral_entropy': spectral_entropy(img),
        'grad_magnitude': gradient_magnitude(img),
        'variance': total_variance(img),
    }
    if ref is not None:
        out['ssim'] = ssim(img, ref)
        out['mutual_information'] = mutual_information(img, ref)
    return out
