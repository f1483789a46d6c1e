"""CLI: FiTv2 / FiTv1 FID sampling with the PyTorch port.

Usage:
    python -m fitv2_tpu_torch.cli.sample --cfgdir configs/fitv2_xl.yaml \
        --ckpt FiTv2_XL/model_ema.safetensors \
        --image-height 256 --image-width 256 --cfg-scale 1.5 \
        --num-sampling-steps 250 --num-fid-samples 50000 \
        [--interpolation dynntk --ori-max-pe-len 16 --decouple] \
        [--vae path/to/sd-vae.safetensors] [--device cuda] --out samples.npz

FiTv1 (a ``learn_sigma`` network such as configs/fit_xl.yaml) samples with
``--sampler-mode ddpm`` or ``ddim``: improved-diffusion loops over the
training ladder respaced to ``--num-sampling-steps``, with the diffusion
keys of the config's ``diffusion`` section (``noise_schedule``,
``diffusion_steps``, ... or an ``improved_diffusion:`` subsection).

The flags are those of ``fitv2_tpu.cli.sample`` plus ``--device``. The
serving speed modes compose: ``--gemm-precision int8`` (W8A8 GEMMs,
calibrated when the sampler is built), ``--guidance-low/--guidance-high``
(CFG only inside a t window) and ``--velocity-eval-every N
[--velocity-extrap-order 2]`` (the model on every N-th step only).
``--interpolation`` samples a bucket beyond the training grid with that
RoPE frequency mode; ``no`` (the default) samples with normal frequencies,
online RoPE off, as the JAX CLI does, also for the HR configs.

``--data-parallel``: under ``torchrun --nproc_per_node N -m
fitv2_tpu_torch.cli.sample --data-parallel ...`` each of the N processes
samples on its card (gloo where they share one) ceil(num_fid_samples / N)
images, its draws keyed by (seed, rank, batch); the images are gathered
in rank order and process 0 writes the npz. With one process it is the
path without the flag, as JAX's flag is with one device.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='FiT FID sampling (PyTorch)')
    p.add_argument('--cfgdir', nargs='+', required=True)
    p.add_argument('--ckpt', required=True,
                   help='reference-layout FiT .safetensors/.bin')
    p.add_argument('--image-height', type=int, default=256)
    p.add_argument('--image-width', type=int, default=256)
    p.add_argument('--cfg-scale', type=float, default=1.5)
    p.add_argument('--num-sampling-steps', type=int, default=250)
    p.add_argument('--num-fid-samples', type=int, default=50_000)
    p.add_argument('--per-device-batch', type=int, default=32)
    p.add_argument('--num-classes', type=int, default=1000)
    p.add_argument('--global-seed', type=int, default=0)
    p.add_argument('--interpolation', default='no',
                   choices=['no', 'linear', 'dynntk', 'ntkpro1', 'ntkpro2',
                            'partntk', 'yarn'])
    p.add_argument('--decouple', action='store_true')
    p.add_argument('--ori-max-pe-len', type=int, default=None)
    p.add_argument('--vae', default=None,
                   help='diffusers sd-vae safetensors/bin; omit to emit '
                        'raw latents')
    p.add_argument('--out', default='samples.npz')
    p.add_argument('--resume-dir', default=None,
                   help='directory for per-batch shards; a restarted run '
                        'skips completed batches')
    p.add_argument('--data-parallel', action='store_true')
    p.add_argument('--gemm-precision', default=None, choices=['bf16', 'int8'],
                   help="override the network's gemm_precision; 'int8' runs "
                        'the block GEMMs as int8 W8A8')
    p.add_argument('--velocity-eval-every', type=int, default=1,
                   help='run the model on every N-th ladder step only, '
                        'extrapolating the velocity in between (1 = dense '
                        'Euler)')
    p.add_argument('--velocity-extrap-order', type=int, default=1,
                   choices=(1, 2),
                   help='extrapolation order: 1 linear, 2 quadratic')
    p.add_argument('--guidance-low', type=float, default=0.0,
                   help='CFG only on steps with t in [guidance-low, '
                        'guidance-high]; the others run one conditional '
                        'forward')
    p.add_argument('--guidance-high', type=float, default=1.0)
    p.add_argument('--sampler-mode', default='ode',
                   choices=['ode', 'ddpm', 'ddim'],
                   help="'ode': flow-matching Euler (FiTv2); 'ddpm' / "
                        "'ddim': FiTv1 improved-diffusion loops, "
                        '--num-sampling-steps the respacing')
    p.add_argument('--device', default='cuda',
                   help="torch device to sample on ('cuda' needs a card; "
                        "'cpu' runs the kernels' plain versions)")
    return p.parse_args(argv)


_DIFFUSION_KEYS = ('noise_schedule', 'diffusion_steps', 'learn_sigma',
                   'sigma_small', 'predict_xstart', 'use_kl',
                   'rescale_learned_sigmas')


def _diffusion_config(diff_cfg: dict) -> dict:
    """create_diffusion's kwargs from a config's ``diffusion`` section: an
    ``improved_diffusion:`` subsection, else flat keys (configs/
    fit_xl.yaml); the subsection wins."""
    out = {k: v for k, v in diff_cfg.get('improved_diffusion', {}).items()
           if k != 'timestep_respacing'}
    for k in _DIFFUSION_KEYS:
        if k in diff_cfg and k not in out:
            out[k] = diff_cfg[k]
    return out


def main(argv=None):
    args = parse_args(argv)
    import numpy as np
    import torch

    from fitv2_tpu_torch.ckpt import load_fit_checkpoint
    from fitv2_tpu_torch.parallel import (
        init_distributed, process_allgather, process_count, process_index,
        sync_global_devices)
    from fitv2_tpu_torch.sample import (
        SamplingConfig, build_sampler, generate_fid_samples, save_npz)
    from fitv2_tpu_torch.utils.config import config_to_model, load_config

    device = torch.device(args.device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('--device cuda but no CUDA device is available')
    if args.data_parallel:
        init_distributed(args.device)  # sets each process's card
    cfg = load_config(args.cfgdir)
    overrides = ({'gemm_precision': args.gemm_precision}
                 if args.gemm_precision else {})
    model = config_to_model(cfg['diffusion']['network_config'], **overrides)
    load_fit_checkpoint(args.ckpt, model)
    model = model.to(device).eval()

    vae = None
    if args.vae:
        from fitv2_tpu_torch.vae import AutoencoderKL, load_vae_state_dict
        vae = AutoencoderKL()
        vae.load_state_dict(load_vae_state_dict(args.vae))
        # bf16 decoder convolutions; GroupNorm statistics stay fp32
        vae = vae.to(device=device, dtype=torch.bfloat16).eval()

    scfg = SamplingConfig(
        image_height=args.image_height, image_width=args.image_width,
        num_sampling_steps=args.num_sampling_steps,
        cfg_scale=args.cfg_scale, num_classes=args.num_classes,
        per_device_batch=args.per_device_batch,
        interpolation=args.interpolation, decouple=args.decouple,
        ori_max_pe_len=args.ori_max_pe_len,
        velocity_eval_every=args.velocity_eval_every,
        velocity_extrap_order=args.velocity_extrap_order,
        guidance_low=args.guidance_low, guidance_high=args.guidance_high,
        sampler_mode=args.sampler_mode,
        diffusion_config=(_diffusion_config(cfg['diffusion'])
                          if args.sampler_mode != 'ode' else None))
    fn = build_sampler(model, scfg, vae)
    images = generate_fid_samples(
        fn, args.num_fid_samples, fn.batch_size, args.num_classes,
        seed=args.global_seed, progress=True, resume_dir=args.resume_dir)
    if process_count() > 1:
        sync_global_devices('samples')
        images = np.concatenate(process_allgather(images), axis=0)
    if process_index() == 0:
        save_npz(args.out, images, args.num_fid_samples)
        print(f'Saved {args.out} [shape={images.shape}]')


if __name__ == '__main__':
    main()
