"""Sampling pipeline: noise -> denoise loop -> VAE -> uint8.

Counterpart of fitv2_tpu/sample/pipeline.py. Two families of loops, each
one eager Python loop on the model's device:
  - FiTv2 ('ode'): the CFG double-batch Euler loop over
    ``euler_ladder(steps)`` (one FiT forward on 2B per step, null class
    ``num_classes``, ``v = uncond + cfg_scale * (cond - uncond)`` over all
    channels);
  - FiTv1 ('ddpm', 'ddim'): improved-diffusion ancestral or DDIM sampling
    over the ladder respaced to ``num_sampling_steps``, the model called
    with the respaced ladder's original integer timesteps through
    ``forward_with_cfg`` on the whole 2B batch (CFG on the first 3 p^2
    channels, the learned-variance channels from each half's own output),
    or on the conditional batch alone when ``cfg_scale <= 1``; x0 is not
    clipped, and the variance channels are dropped before decoding;
then unpatchify, SD-VAE decode and the uint8 conversion.

Training-free speed modes of the Euler loop, composable with each other
and with int8:
  - guidance interval: CFG only on steps whose t lies in [guidance_low,
    guidance_high]; the other steps run one conditional forward at batch B;
  - velocity extrapolation: the model runs on every ``velocity_eval_every``
    -th step only (flow/samplers.euler_sample_extrapolated); composed with
    an interval, extrapolation restarts at each phase boundary;
  - int8 W8A8 (``FiT(gemm_precision='int8')``): the sampler calibrates the
    static activation scales and prequantizes the weights once (any mode).

RoPE resolution extrapolation: ``SamplingConfig.interpolation`` picks the
frequency mode the bucket samples with (``apply_rope_interpolation``);
the model's parameters are shared, only its RoPE config is replaced.

``build_sampler(..., return_trajectory=True)`` also returns each Euler
step's state, the difficulty-analysis capture. ``generate_fid_samples``
runs on every process of a data-parallel group (``parallel.
init_distributed``): each generates its share, keyed by (seed, rank,
batch), and the caller gathers them.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from fitv2_tpu_torch.flow.samplers import (
    cfg_model_fn, euler_ladder, euler_sample, euler_sample_extrapolated)
from fitv2_tpu_torch.kernels.quant import (
    QuantBinding, calibrate_quant_scales, load_quant_state,
    prequantize_weights)
from fitv2_tpu_torch.models.fit import forward_with_cfg
from fitv2_tpu_torch.models.grid_utils import (
    make_grid_mask_size, pixels_to_tokens)
from fitv2_tpu_torch.models.rope import RopeConfig
from fitv2_tpu_torch.parallel.mesh import process_count, process_index
from fitv2_tpu_torch.sched.gaussian_diffusion import create_diffusion
from fitv2_tpu_torch.vae.autoencoder_kl import images_to_uint8

Tensor = torch.Tensor

# built-in int8 calibration: (noise scale, t) of each batch, as in JAX
CALIBRATION_POINTS = ((1.0, 0.05), (0.9, 0.3), (0.8, 0.6), (0.7, 0.9))
CALIBRATION_SEED = 0

# CLI name -> RoPE frequency mode. 'keep' samples with the model's own RoPE
# config (the HR configs' online decoupled NTK)
INTERPOLATION_MODES = {
    'no': 'normal',
    'keep': None,
    'linear': 'linear',
    'dynntk': 'ntk-aware',
    'ntkpro1': 'ntk-aware-pro1',
    'ntkpro2': 'ntk-aware-pro2',
    'partntk': 'ntk-by-parts',
    'yarn': 'yarn',
}


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    image_height: int = 256
    image_width: int = 256
    num_sampling_steps: int = 250
    cfg_scale: float = 1.5
    num_classes: int = 1000
    per_device_batch: int = 8
    interpolation: str = 'no'        # key of INTERPOLATION_MODES
    decouple: bool = False
    ori_max_pe_len: Optional[int] = None  # the training grid's side
    vae_scale: float = 0.18215
    # the state z is cast to this dtype as the model's input every step, and
    # the VAE decodes latents in it
    dtype: torch.dtype = torch.bfloat16
    # run the model on every N-th ladder step only, extrapolating the
    # velocity in between (1 = dense Euler); order 1 linear, 2 quadratic
    velocity_eval_every: int = 1
    velocity_extrap_order: int = 1
    # CFG only on steps with guidance_low <= t <= guidance_high; the other
    # steps run one conditional forward at batch B. (0, 1) = CFG throughout
    guidance_low: float = 0.0
    guidance_high: float = 1.0
    # 'ode' (FiTv2 flow-matching Euler) or 'ddpm' / 'ddim' (FiTv1
    # improved diffusion, num_sampling_steps the respacing)
    sampler_mode: str = 'ode'
    # create_diffusion's kwargs for 'ddpm' / 'ddim' (noise_schedule,
    # diffusion_steps, learn_sigma, ...); timestep_respacing is always
    # str(num_sampling_steps)
    diffusion_config: Optional[Dict[str, Any]] = None


def _float64_ladder(steps: int) -> np.ndarray:
    """JAX's float64 ladder (``np.linspace``): its guidance interval decides
    the CFG window on it and, when the model runs on every step, scans it
    rounded to float32 (fitv2_tpu/sample/pipeline.py:196-203, 337-342)."""
    return np.linspace(0.0, 1.0, steps + 1)


def guidance_phases(cfg: SamplingConfig) -> tuple[int, int]:
    """Ladder indices [i0, i1) of the CFG window: steps before i0 and from
    i1 on are conditional only. Decided on the float64 ladder, as in JAX."""
    t_cur = _float64_ladder(cfg.num_sampling_steps)[:-1]
    idx = np.flatnonzero((t_cur >= cfg.guidance_low)
                         & (t_cur <= cfg.guidance_high))
    return (int(idx[0]), int(idx[-1]) + 1) if idx.size else (0, 0)


def apply_rope_interpolation(model, cfg: SamplingConfig) -> RopeConfig:
    """The RoPE config the model samples ``cfg``'s bucket with.

    'keep': the model's own; 'no': normal frequencies, online off; any
    other mode: that mode with ``max_pe_len_h/w`` the target token grid,
    ``decouple`` and ``ori_max_pe_len`` from ``cfg``, online off and the
    cached tables long enough for the grid.
    """
    if cfg.interpolation not in INTERPOLATION_MODES:
        raise ValueError(f'interpolation={cfg.interpolation!r}: use one of '
                         f'{sorted(INTERPOLATION_MODES)}')
    rc = model.rope_config
    if cfg.interpolation == 'keep':
        return rc
    if cfg.interpolation == 'no':
        return dataclasses.replace(rc, mode='normal', online=False)
    if cfg.ori_max_pe_len is None:
        raise ValueError('interpolated sampling needs ori_max_pe_len (the '
                         'training grid size)')
    n_h, n_w = pixels_to_tokens(cfg.image_height, cfg.image_width,
                                model.patch_size)
    return dataclasses.replace(
        rc, mode=INTERPOLATION_MODES[cfg.interpolation], max_pe_len_h=n_h,
        max_pe_len_w=n_w, decouple=cfg.decouple,
        ori_max_pe_len=cfg.ori_max_pe_len, online=False,
        max_cached_len=max(rc.max_cached_len, n_h, n_w))


def build_sampler(model, cfg: SamplingConfig, vae=None,
                  quant_collections: Optional[Dict[str, Tensor]] = None,
                  context_size: Optional[int] = None,
                  prequantize: bool = True,
                  return_trajectory: bool = False) -> Callable[..., Any]:
    """Returns ``sample_fn(labels, generator=None, z=None,
    step_noise=None)``.

    labels: (B,) integer class ids. The noise is ``z`` (B, n_ctx, p**2*C)
    float32 when given, else drawn with ``torch.randn`` from ``generator``
    (a CPU ``torch.Generator``, so a seed gives the same noise on any
    device). The 'ddpm' loop (and 'ddim' at eta > 0) also takes a fresh
    normal draw a step: ``step_noise`` (steps, B', n_ctx, p**2*C), with B'
    = 2B under CFG, whose loop state is the doubled batch, else one draw
    of that shape from ``generator`` after z. Returns uint8 (B, H, W, 3)
    images with a VAE, else latents (B, C, H/8, W/8) float32, on the
    model's device.

    An int8 model (``gemm_precision='int8'``) is quantized in place here:
    with ``quant_collections`` (``Int8Linear`` buffers by name, e.g. from
    ``fitv2_tpu_torch.ckpt.quant_state_from_jax``) exactly those are bound;
    without, the built-in calibration runs four forwards on seeded noise
    (``CALIBRATION_POINTS``; labels class 0 and null) and the weights are
    prequantized (``prequantize=False`` keeps the int8 weights already
    bound on the module: a ``BucketedSampler``'s later buckets share its
    first bucket's). The sampler keeps its own activation scales and binds
    them at each call, so samplers of several buckets share one module.
    The calibration noise comes from a seeded CPU ``torch.Generator``, so
    it differs from the JAX sampler's ``jax.random`` draw and the scales
    differ slightly from JAX's.

    ``context_size`` pads the tokens to that length instead of the model's
    own (a bucket larger than the training context; the weights are
    shared, as JAX's ``model.clone(context_size=...)`` shares its params).

    ``return_trajectory`` makes ``sample_fn`` return (out, traj): traj
    (steps, B, n_ctx, p**2*C) float32 holds each Euler step's state, the
    last one the state decoded. Only the dense full-interval Euler loop
    has one: with ``velocity_eval_every > 1``, a guidance interval or
    ddpm/ddim it raises ValueError, as JAX's does.
    """
    use_interval = (cfg.guidance_low, cfg.guidance_high) != (0.0, 1.0)
    if cfg.velocity_eval_every > 1 and return_trajectory:
        raise ValueError(
            'velocity_eval_every > 1 is not supported with '
            'return_trajectory=True (the extrapolated sampler does not '
            'materialize per-step states); use velocity_eval_every=1 for '
            'trajectory dumps')
    if use_interval and return_trajectory:
        raise ValueError(
            'guidance_low/high does not compose with return_trajectory; '
            'use the full-interval path for trajectory dumps')
    diffusion = None
    if cfg.sampler_mode in ('ddpm', 'ddim'):
        if cfg.velocity_eval_every > 1 or use_interval:
            raise ValueError('sampler_mode ddpm/ddim composes with neither '
                             'velocity_eval_every nor guidance_low/high '
                             '(flow-ladder features)')
        if return_trajectory:
            raise ValueError('sampler_mode ddpm/ddim composes with none of '
                             'velocity_eval_every / guidance_low/high / '
                             'return_trajectory (flow-ladder features)')
        dc = dict(cfg.diffusion_config or {})
        dc.pop('timestep_respacing', None)
        diffusion = create_diffusion(
            timestep_respacing=str(cfg.num_sampling_steps), **dc)
    elif cfg.sampler_mode != 'ode':
        raise ValueError(f"sampler_mode must be 'ode', 'ddpm' or 'ddim', "
                         f'got {cfg.sampler_mode!r}')
    elif model.learn_sigma:
        raise ValueError("sampler_mode='ode' (flow-matching Euler) needs a "
                         'velocity model (learn_sigma=False); a '
                         "learned-sigma FiTv1 model samples with 'ddpm' or "
                         "'ddim'")
    if cfg.velocity_extrap_order not in (1, 2):
        raise ValueError(f'velocity_extrap_order must be 1 or 2, got '
                         f'{cfg.velocity_extrap_order}')
    if cfg.velocity_eval_every < 1:
        raise ValueError(f'velocity_eval_every must be >= 1, got '
                         f'{cfg.velocity_eval_every}')
    device = next(model.parameters()).device
    n_h, n_w = pixels_to_tokens(cfg.image_height, cfg.image_width,
                                model.patch_size)
    lat_h, lat_w = cfg.image_height // 8, cfg.image_width // 8
    n_ctx = context_size or model.context_size
    if n_h * n_w > n_ctx:
        raise ValueError(f'bucket {n_h}x{n_w} exceeds context {n_ctx}; '
                         'pass a larger context_size for this bucket')
    rope_cfg = apply_rope_interpolation(model, cfg)
    B = cfg.per_device_batch
    token_dim = model.patch_size ** 2 * model.in_channels

    def bucket_inputs(batch: int):
        """grid/mask/size and the bucket's RoPE tables (computed once: they
        do not depend on t) at a batch; on a full bucket the mask is
        statically absent (no key masking, no padded-output zeroing:
        identical results)."""
        g, m, s = make_grid_mask_size(batch, n_h, n_w, n_ctx, device)
        return (g, None if n_h * n_w == n_ctx else m, s,
                model.rope(g, s, config=rope_cfg))

    grid, mask, size, rope = bucket_inputs(2 * B)
    y_null = torch.full((B,), cfg.num_classes, dtype=torch.int64,
                        device=device)
    steps = cfg.num_sampling_steps
    # JAX's ladders: jnp.linspace, except for the guidance interval's
    # every-step scan, which runs on the float64 ladder rounded to float32
    if use_interval and cfg.velocity_eval_every == 1:
        sigmas = _float64_ladder(steps).astype(np.float32)
    else:
        sigmas = euler_ladder(steps)
    i0, i1 = guidance_phases(cfg) if use_interval else (0, steps)
    if use_interval or (diffusion is not None and cfg.cfg_scale <= 1.0):
        grid_c, mask_c, size_c, rope_c = bucket_inputs(B)

    if quant_collections is not None:
        load_quant_state(model, quant_collections)
    elif model.gemm_precision == 'int8':
        gen = torch.Generator().manual_seed(CALIBRATION_SEED)
        zc = torch.randn((2 * B, n_ctx, token_dim), generator=gen).to(device)
        yc = torch.cat([torch.zeros_like(y_null), y_null])
        calibrate_quant_scales(model, [
            (zc * s, torch.full((2 * B,), t, device=device), yc, grid, mask,
             size, rope) for s, t in CALIBRATION_POINTS])
        if prequantize:
            prequantize_weights(model)
    # this sampler's scales, put back on the (possibly shared) module at
    # every call: another bucket's sampler may have bound its own since
    quant = QuantBinding(model) if model.gemm_precision == 'int8' else None

    def decode(z: Tensor) -> Tensor:
        """Valid tokens -> unpatchify -> (optional) VAE -> uint8."""
        latents = model.unpatchify(z[:, :n_h * n_w], (lat_h, lat_w),
                                   channel_last=True)
        latents = latents[..., :model.in_channels]
        if vae is None:
            return latents.permute(0, 3, 1, 2)
        images = vae.decode(latents.to(cfg.dtype) / cfg.vae_scale)
        return images_to_uint8(images)

    def diffusion_loop(z: Tensor, labels: Tensor, y: Tensor,
                       generator: Optional[torch.Generator],
                       step_noise: Optional[Tensor]) -> Tensor:
        """FiTv1: the ddpm or ddim loop over the respaced ladder from z;
        returns the conditional half of the final state."""
        if cfg.cfg_scale > 1.0:
            def model_fn(x: Tensor, t: Tensor) -> Tensor:
                return forward_with_cfg(
                    model, x.to(cfg.dtype), t.float(), y, grid, mask, size,
                    cfg.cfg_scale, rope=rope).float()
            noise = torch.cat([z, z], dim=0)
        else:
            def model_fn(x: Tensor, t: Tensor) -> Tensor:
                return model(x.to(cfg.dtype), t.float(), labels, grid_c,
                             mask_c, size_c, rope=rope_c).float()
            noise = z
        loop = (diffusion.p_sample_loop if cfg.sampler_mode == 'ddpm'
                else diffusion.ddim_sample_loop)
        out = loop(model_fn, tuple(noise.shape), noise=noise,
                   clip_denoised=False, step_noise=step_noise,
                   generator=generator)
        return out[:B]

    @torch.no_grad()
    def sample_fn(labels: Tensor, generator: Optional[torch.Generator] = None,
                  z: Optional[Tensor] = None,
                  step_noise: Optional[Tensor] = None) -> Tensor:
        if labels.shape != (B,):
            raise ValueError(f'labels must be ({B},), got {tuple(labels.shape)}')
        if z is None:
            z = torch.randn((B, n_ctx, token_dim), generator=generator,
                            dtype=torch.float32)
        elif z.shape != (B, n_ctx, token_dim):
            raise ValueError(f'z must be {(B, n_ctx, token_dim)}, got '
                             f'{tuple(z.shape)}')
        z = z.to(device=device, dtype=torch.float32)
        labels = labels.to(device=device, dtype=torch.int64)
        if quant is not None:
            quant.bind()
        y = torch.cat([labels, y_null])
        if diffusion is not None:
            return decode(diffusion_loop(z, labels, y, generator, step_noise))
        if step_noise is not None:
            raise ValueError("step_noise is for sampler_mode 'ddpm' / 'ddim'")

        drift = cfg_model_fn(
            lambda x2, t2: model(x2.to(cfg.dtype), t2, y, grid, mask, size,
                                 rope=rope).float(), cfg.cfg_scale)
        phases = [(i0, i1, drift)]
        if use_interval:
            def drift_cond(x: Tensor, t: Tensor) -> Tensor:
                return model(x.to(cfg.dtype), t, labels, grid_c, mask_c,
                             size_c, rope=rope_c).float()
            phases = [(0, i0, drift_cond), phases[0],
                      (i1, steps, drift_cond)]
        if return_trajectory:  # one dense phase: the refusals above
            z, traj = euler_sample(drift, z, sigmas, return_trajectory=True)
            return decode(z), traj
        # each phase integrates its own sub-ladder; extrapolation restarts
        # at phase boundaries, where the drift changes meaning
        for a, b, fn in phases:
            if b <= a:
                continue
            if cfg.velocity_eval_every > 1:
                z = euler_sample_extrapolated(
                    fn, z, sigmas[a:b + 1], eval_every=cfg.velocity_eval_every,
                    order=cfg.velocity_extrap_order)
            else:
                z = euler_sample(fn, z, sigmas[a:b + 1])
        return decode(z)

    sample_fn.batch_size = B
    # stable fingerprint of everything that changes the sampled
    # distribution; generate_fid_samples stamps it into a resume dir
    fp_src = (f'{cfg!r}|model={type(model).__name__}|nh={n_h}|nw={n_w}'
              f'|ctx={n_ctx}|vae={vae is not None}|quant={quant_collections is not None}'
              f'|int8={model.gemm_precision}')
    sample_fn.config_fingerprint = hashlib.sha1(
        fp_src.encode()).hexdigest()[:16]
    return sample_fn


def _batch_inputs(seed: int, batch_index: int, batch: int, num_classes: int,
                  rank: int = 0) -> tuple[Tensor, torch.Generator]:
    """Labels and a noise generator for one FID batch of process ``rank``,
    derived from (seed, batch index, rank) only, so a resumed run draws
    what an uninterrupted run would. Process 0's entropy is [seed, batch
    index], that of the one-process loop."""
    ss = np.random.SeedSequence([seed, batch_index] + ([rank] if rank else []))
    label_seed, noise_seed = ss.generate_state(2, dtype=np.uint64)
    labels = torch.from_numpy(np.random.default_rng(label_seed).integers(
        0, num_classes, size=batch, dtype=np.int64))
    return labels, torch.Generator().manual_seed(int(noise_seed))


def generate_fid_samples(sample_fn: Callable, num_fid_samples: int,
                         per_device_batch: int, num_classes: int = 1000,
                         seed: int = 0, progress: bool = False,
                         resume_dir: Optional[str] = None) -> np.ndarray:
    """FID generation loop of this process.

    Data parallel (``parallel.init_distributed``), each of the P processes
    generates ceil(N / P) samples, its draws keyed by (seed, rank, batch);
    gather them in rank order with ``parallel.process_allgather``. One
    process generates N, as before.

    resume_dir makes the loop preemption-safe: each finished batch is
    written there atomically (temporary file + rename); on a rerun, batches
    whose shard exists are loaded instead of sampled. A manifest (seed,
    batch, sample count, classes, sampler fingerprint and, data parallel,
    the process count) is stamped into the directory by process 0, and a
    rerun with a different one is refused. Data parallel, the shards are
    named by rank.
    """
    rank, world = process_index(), process_count()
    per_proc = int(np.ceil(num_fid_samples / world))
    n_batches = int(np.ceil(per_proc / per_device_batch))
    if resume_dir:
        os.makedirs(resume_dir, exist_ok=True)
        manifest = {
            'seed': int(seed), 'per_device_batch': int(per_device_batch),
            'num_fid_samples': int(num_fid_samples),
            'num_classes': int(num_classes),
            'config_fingerprint': getattr(sample_fn, 'config_fingerprint',
                                          None)}
        if world > 1:
            manifest['process_count'] = world
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
        elif rank == 0:
            tmp = mpath + '.tmp'
            with open(tmp, 'w') as f:
                json.dump(manifest, f)
            os.replace(tmp, mpath)

    def shard_path(bi: int) -> str:
        name = f'shard_p{rank}_b{bi}.npy' if world > 1 else f'shard_b{bi}.npy'
        return os.path.join(resume_dir, name)

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
        labels, gen = _batch_inputs(seed, bi, per_device_batch, num_classes,
                                    rank)
        imgs = sample_fn(labels, generator=gen).cpu().numpy()
        if resume_dir:
            tmp = shard_path(bi) + '.tmp.npy'
            np.save(tmp, imgs)
            os.replace(tmp, shard_path(bi))
        out.append(imgs)
        if progress and rank == 0:
            print(f'batch {bi + 1}/{n_batches}', flush=True)
    return np.concatenate(out, axis=0)[:per_proc]


def save_npz(path: str, images: np.ndarray,
             num_fid_samples: Optional[int] = None) -> None:
    """ADM-evaluation-suite-compatible npz (``arr_0``)."""
    if num_fid_samples is not None:
        images = images[:num_fid_samples]
    np.savez(path, arr_0=images)
