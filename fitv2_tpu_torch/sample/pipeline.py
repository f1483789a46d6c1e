"""FiTv2 sampling pipeline: noise -> CFG Euler denoise -> VAE -> uint8.

Counterpart of the flow-matching path of fitv2_tpu/sample/pipeline.py: the
CFG double-batch Euler loop over ``linspace(0, 1, steps + 1)`` (one FiT
forward on 2B per step, null class ``num_classes``, ``v = uncond +
cfg_scale * (cond - uncond)`` over all channels), unpatchify, SD-VAE
decode and the uint8 conversion. It runs eagerly on the model's device.

Not ported yet (the CLI refuses their flags): RoPE interpolation other than
'no' (HR slice), guidance intervals and velocity extrapolation (speed-mode
slice), DDPM/DDIM (FiTv1 slice), data-parallel sampling (multi-device).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Callable, Optional

import numpy as np
import torch

from fitv2_tpu_torch.models.grid_utils import (
    make_grid_mask_size, pixels_to_tokens)
from fitv2_tpu_torch.vae.autoencoder_kl import images_to_uint8

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    image_height: int = 256
    image_width: int = 256
    num_sampling_steps: int = 250
    cfg_scale: float = 1.5
    num_classes: int = 1000
    per_device_batch: int = 8
    vae_scale: float = 0.18215
    # the state z is cast to this dtype as the model's input every step, and
    # the VAE decodes latents in it
    dtype: torch.dtype = torch.bfloat16


def build_sampler(model, cfg: SamplingConfig, vae=None
                  ) -> Callable[..., Tensor]:
    """Returns ``sample_fn(labels, generator=None, z=None)``.

    labels: (B,) integer class ids. The noise is ``z`` (B, n_ctx, p**2*C)
    float32 when given, else drawn with ``torch.randn`` from ``generator``
    (a CPU ``torch.Generator``, so a seed gives the same noise on any
    device). Returns uint8 (B, H, W, 3) images with a VAE, else latents
    (B, C, H/8, W/8) float32, on the model's device.
    """
    if model.learn_sigma:
        raise ValueError('flow-matching Euler sampling needs a velocity '
                         'model (learn_sigma=False)')
    device = next(model.parameters()).device
    n_h, n_w = pixels_to_tokens(cfg.image_height, cfg.image_width,
                                model.patch_size)
    lat_h, lat_w = cfg.image_height // 8, cfg.image_width // 8
    n_ctx = model.context_size
    if n_h * n_w > n_ctx:
        raise ValueError(f'bucket {n_h}x{n_w} exceeds context {n_ctx}')
    B = cfg.per_device_batch
    token_dim = model.patch_size ** 2 * model.in_channels

    grid, mask, size = make_grid_mask_size(2 * B, n_h, n_w, n_ctx, device)
    # on a full bucket the mask is statically absent: no key masking and
    # no padded-output zeroing (identical results)
    mask = None if n_h * n_w == n_ctx else mask
    # RoPE interpolation 'no' (the only one ported): normal frequencies
    rope = model.rope(grid, mode='normal')
    y_null = torch.full((B,), cfg.num_classes, dtype=torch.int64,
                        device=device)
    sigmas = torch.linspace(0.0, 1.0, cfg.num_sampling_steps + 1,
                            dtype=torch.float32)
    t_cur = sigmas[:-1].tolist()
    dts = (sigmas[1:] - sigmas[:-1]).tolist()  # float32 step sizes

    def decode(z: Tensor) -> Tensor:
        """Valid tokens -> unpatchify -> (optional) VAE -> uint8."""
        latents = model.unpatchify(z[:, :n_h * n_w], (lat_h, lat_w),
                                   channel_last=True)
        latents = latents[..., :model.in_channels]
        if vae is None:
            return latents.permute(0, 3, 1, 2)
        images = vae.decode(latents.to(cfg.dtype) / cfg.vae_scale)
        return images_to_uint8(images)

    @torch.no_grad()
    def sample_fn(labels: Tensor, generator: Optional[torch.Generator] = None,
                  z: Optional[Tensor] = None) -> Tensor:
        if labels.shape != (B,):
            raise ValueError(f'labels must be ({B},), got {tuple(labels.shape)}')
        if z is None:
            z = torch.randn((B, n_ctx, token_dim), generator=generator,
                            dtype=torch.float32)
        elif z.shape != (B, n_ctx, token_dim):
            raise ValueError(f'z must be {(B, n_ctx, token_dim)}, got '
                             f'{tuple(z.shape)}')
        z = z.to(device=device, dtype=torch.float32)
        y = torch.cat([labels.to(device=device, dtype=torch.int64), y_null])
        for t, dt in zip(t_cur, dts):
            z_in = torch.cat([z, z], dim=0).to(cfg.dtype)
            t2 = torch.full((2 * B,), t, dtype=torch.float32, device=device)
            out = model(z_in, t2, y, grid, mask, size, rope=rope)
            cond, uncond = out.float().chunk(2, dim=0)
            z = z + dt * (uncond + cfg.cfg_scale * (cond - uncond))
        return decode(z)

    sample_fn.batch_size = B
    # stable fingerprint of everything that changes the sampled
    # distribution; generate_fid_samples stamps it into a resume dir
    fp_src = (f'{cfg!r}|model={type(model).__name__}|nh={n_h}|nw={n_w}'
              f'|vae={vae is not None}')
    sample_fn.config_fingerprint = hashlib.sha1(
        fp_src.encode()).hexdigest()[:16]
    return sample_fn


def _batch_inputs(seed: int, batch_index: int, batch: int, num_classes: int
                 ) -> tuple[Tensor, torch.Generator]:
    """Labels and a noise generator for one FID batch, derived from
    (seed, batch index) only, so a resumed run draws what an uninterrupted
    run would."""
    ss = np.random.SeedSequence([seed, batch_index])
    label_seed, noise_seed = ss.generate_state(2, dtype=np.uint64)
    labels = torch.from_numpy(np.random.default_rng(label_seed).integers(
        0, num_classes, size=batch, dtype=np.int64))
    return labels, torch.Generator().manual_seed(int(noise_seed))


def generate_fid_samples(sample_fn: Callable, num_fid_samples: int,
                         per_device_batch: int, num_classes: int = 1000,
                         seed: int = 0, progress: bool = False,
                         resume_dir: Optional[str] = None) -> np.ndarray:
    """FID generation loop on one device.

    resume_dir makes the loop preemption-safe: each finished batch is
    written there atomically (temporary file + rename); on a rerun, batches
    whose shard exists are loaded instead of sampled. A manifest (seed,
    batch, sample count, classes, sampler fingerprint) is stamped into the
    directory, and a rerun with a different one is refused.
    """
    n_batches = int(np.ceil(num_fid_samples / per_device_batch))
    if resume_dir:
        os.makedirs(resume_dir, exist_ok=True)
        manifest = {
            'seed': int(seed), 'per_device_batch': int(per_device_batch),
            'num_fid_samples': int(num_fid_samples),
            'num_classes': int(num_classes),
            'config_fingerprint': getattr(sample_fn, 'config_fingerprint',
                                          None)}
        mpath = os.path.join(resume_dir, 'manifest.json')
        if os.path.exists(mpath):
            with open(mpath) as f:
                prev = json.load(f)
            if prev != manifest:
                diff = {k: (prev.get(k), manifest[k]) for k in manifest
                        if prev.get(k) != manifest[k]}
                raise ValueError(
                    f'resume_dir {resume_dir} holds shards from a different '
                    f'run (manifest mismatch, existing vs requested: {diff});'
                    f' point --resume-dir at a fresh directory or delete it')
        else:
            tmp = mpath + '.tmp'
            with open(tmp, 'w') as f:
                json.dump(manifest, f)
            os.replace(tmp, mpath)

    def shard_path(bi: int) -> str:
        return os.path.join(resume_dir, f'shard_b{bi}.npy')

    out = []
    for bi in range(n_batches):
        if resume_dir and os.path.exists(shard_path(bi)):
            try:
                arr = np.load(shard_path(bi))
            except (OSError, ValueError):
                arr = None  # unreadable shard: sample the batch again
            if arr is not None and len(arr) == per_device_batch:
                out.append(arr)
                continue
        labels, gen = _batch_inputs(seed, bi, per_device_batch, num_classes)
        imgs = sample_fn(labels, generator=gen).cpu().numpy()
        if resume_dir:
            tmp = shard_path(bi) + '.tmp.npy'
            np.save(tmp, imgs)
            os.replace(tmp, shard_path(bi))
        out.append(imgs)
        if progress:
            print(f'batch {bi + 1}/{n_batches}', flush=True)
    return np.concatenate(out, axis=0)[:num_fid_samples]


def save_npz(path: str, images: np.ndarray,
             num_fid_samples: Optional[int] = None) -> None:
    """ADM-evaluation-suite-compatible npz (``arr_0``)."""
    if num_fid_samples is not None:
        images = images[:num_fid_samples]
    np.savez(path, arr_0=images)
