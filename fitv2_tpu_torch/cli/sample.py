"""CLI: FiTv2 FID sampling with the PyTorch port.

Usage:
    python -m fitv2_tpu_torch.cli.sample --cfgdir configs/fitv2_xl.yaml \
        --ckpt FiTv2_XL/model_ema.safetensors \
        --image-height 256 --image-width 256 --cfg-scale 1.5 \
        --num-sampling-steps 250 --num-fid-samples 50000 \
        [--vae path/to/sd-vae.safetensors] [--device cuda] --out samples.npz

The flags are those of ``fitv2_tpu.cli.sample`` plus ``--device``. Flags
of modes that are not ported yet are accepted by the parser and refused
with an error that names the missing slice.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='FiTv2 FID sampling (PyTorch)')
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
    p.add_argument('--gemm-precision', default=None, choices=['bf16', 'int8'])
    p.add_argument('--velocity-eval-every', type=int, default=1)
    p.add_argument('--velocity-extrap-order', type=int, default=1,
                   choices=(1, 2))
    p.add_argument('--guidance-low', type=float, default=0.0)
    p.add_argument('--guidance-high', type=float, default=1.0)
    p.add_argument('--sampler-mode', default='ode',
                   choices=['ode', 'ddpm', 'ddim'])
    p.add_argument('--device', default='cuda',
                   help="torch device to sample on ('cuda' needs a card; "
                        "'cpu' runs the kernels' plain versions)")
    return p.parse_args(argv)


def _refuse_unported(args) -> None:
    """Raise for flags whose mode belongs to a slice not ported yet."""
    unported = [
        (args.gemm_precision == 'int8', '--gemm-precision int8',
         'int8 serving (slice 3)'),
        ((args.guidance_low, args.guidance_high) != (0.0, 1.0),
         '--guidance-low/--guidance-high', 'interval guidance (slice 3)'),
        (args.velocity_eval_every != 1 or args.velocity_extrap_order != 1,
         '--velocity-eval-every/--velocity-extrap-order',
         'velocity extrapolation (slice 3)'),
        (args.interpolation != 'no', f'--interpolation {args.interpolation}',
         'HR / resolution extrapolation (slice 4)'),
        (args.sampler_mode != 'ode', f'--sampler-mode {args.sampler_mode}',
         'FiTv1 DDPM/DDIM sampling (slice 6)'),
        (args.data_parallel, '--data-parallel', 'multi-device (slice 9)'),
    ]
    for hit, flag, slice_name in unported:
        if hit:
            raise NotImplementedError(
                f'{flag}: {slice_name} is not ported to fitv2_tpu_torch yet; '
                'use fitv2_tpu.cli.sample for it')


def main(argv=None):
    args = parse_args(argv)
    _refuse_unported(args)
    import torch

    from fitv2_tpu_torch.ckpt import load_fit_checkpoint
    from fitv2_tpu_torch.sample import (
        SamplingConfig, build_sampler, generate_fid_samples, save_npz)
    from fitv2_tpu_torch.utils.config import config_to_model, load_config

    device = torch.device(args.device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('--device cuda but no CUDA device is available')
    cfg = load_config(args.cfgdir)
    model = config_to_model(cfg['diffusion']['network_config'])
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
        per_device_batch=args.per_device_batch)
    fn = build_sampler(model, scfg, vae)
    images = generate_fid_samples(
        fn, args.num_fid_samples, fn.batch_size, args.num_classes,
        seed=args.global_seed, progress=True, resume_dir=args.resume_dir)
    save_npz(args.out, images, args.num_fid_samples)
    print(f'Saved {args.out} [shape={images.shape}]')


if __name__ == '__main__':
    main()
