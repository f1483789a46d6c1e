"""CLI: LwD / BFM sampling with the PyTorch port.

Usage:
    python -m fitv2_tpu_torch.cli.sample_lwd --cfgdir configs/bfm.yaml \
        --ckpt runs/bfm/checkpoints/checkpoint-400000 \
        --sampler maruyama --cfg-scale 1.4 --steps-per-flow 42 \
        --num-fid-samples 50000 [--vae sd-vae.safetensors] \
        [--device cuda] --out samples.npz

The flags are those of ``fitv2_tpu.cli.sample_lwd`` plus ``--device``.
``--ckpt`` is a port training checkpoint directory (``checkpoint-{step}/
train_state.pt``, fitv2_tpu_torch/ckpt/checkpoint.py), whose EMA
parameters are sampled. The model is built on the device in the config's
dtype (a ``dtype: bfloat16`` param in a merged YAML samples in bf16).
Labels, the starting noise and the SDE samplers' draws of each batch come
from CPU ``torch.Generator``s seeded from (``--global-seed``, the batch
index), so a seed gives the same samples on any device. With ``--vae``
the latents are decoded in bf16 to uint8 images; without, the npz holds
the latents (B, H/8, W/8, C). The npz is the ADM suite's (``arr_0``).
"""

from __future__ import annotations

import argparse
import os
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='LwD/BFM sampling (PyTorch)')
    p.add_argument('--cfgdir', nargs='+', required=True)
    p.add_argument('--ckpt', required=True,
                   help='checkpoint-{step} directory of a port training run '
                        '(its ema_params are sampled)')
    p.add_argument('--sampler', default='cfg',
                   choices=['plain', 'cfg', 'maruyama', 'maruyama_global',
                            'multiscale'])
    p.add_argument('--global-steps', type=int, default=250,
                   help='sigma-grid points for the maruyama_global sampler '
                        '(sharedenc models only)')
    p.add_argument('--self-guidance', action='store_true',
                   help='representation self-guidance (sharedenc models)')
    p.add_argument('--cfg-scale', type=float, default=1.4)
    p.add_argument('--steps-per-flow', type=int, default=1,
                   help='Euler sub-steps per segment '
                        '(reference number_of_step_perflow)')
    p.add_argument('--guidance-low', type=float, default=0.0)
    p.add_argument('--guidance-high', type=float, default=1.0)
    p.add_argument('--num-fid-samples', type=int, default=50_000)
    p.add_argument('--per-device-batch', type=int, default=32)
    p.add_argument('--global-seed', type=int, default=0)
    p.add_argument('--vae', default=None,
                   help='diffusers sd-vae safetensors/bin; omit to emit '
                        'raw latents')
    p.add_argument('--out', default='samples_lwd.npz')
    p.add_argument('--device', default='cuda',
                   help="torch device to sample on ('cuda' needs a card; "
                        "'cpu' runs the kernels' plain versions)")
    return p.parse_args(argv)


def batch_inputs(seed: int, batch_index: int, batch: int, tokens: int,
                 token_dim: int, num_classes: int):
    """Labels (B,), the starting noise (B, tokens, token_dim) and the
    sampler's noise generator of one batch, each from a CPU generator
    seeded from (seed, batch index, which)."""
    import numpy as np
    import torch
    seeds = np.random.SeedSequence([seed, batch_index]).generate_state(
        3, dtype=np.uint64)
    gens = [torch.Generator().manual_seed(int(s)) for s in seeds]
    y = torch.randint(0, num_classes, (batch,), generator=gens[0])
    z = torch.randn((batch, tokens, token_dim), generator=gens[1])
    return y, z, gens[2]


def sampler_fn(model, args):
    """``fn(z, y, generator)`` -> final tokens, for ``--sampler``."""
    return {
        'plain': lambda z, y, g: model.sample(z, y, args.steps_per_flow),
        'cfg': lambda z, y, g: model.sample_cfg(
            z, y, args.cfg_scale, args.steps_per_flow),
        'maruyama': lambda z, y, g: model.sample_maruyama_cfg(
            z, y, args.cfg_scale, args.steps_per_flow, args.guidance_low,
            args.guidance_high, generator=g, **(
                {'self_guidance': True} if args.self_guidance else {})),
        'maruyama_global': lambda z, y, g: model.sample_maruyama_global_cfg(
            z, y, args.cfg_scale, args.global_steps, args.guidance_low,
            args.guidance_high, args.self_guidance, generator=g),
        'multiscale': lambda z, y, g: model.sample_multiscale(
            z, y, args.steps_per_flow, generator=g),
    }[args.sampler]


def main(argv=None):
    args = parse_args(argv)
    import numpy as np
    import torch

    from fitv2_tpu_torch.ckpt import CheckpointManager
    from fitv2_tpu_torch.sample import save_npz
    from fitv2_tpu_torch.utils.config import config_to_model, load_config
    from fitv2_tpu_torch.vae import images_to_uint8

    device = torch.device(args.device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('--device cuda but no CUDA device is available')
    cfg = load_config(args.cfgdir)
    with device:
        model = config_to_model(cfg['diffusion']['network_config'])
    ckpt_dir, step_name = os.path.split(os.path.abspath(args.ckpt))
    state = CheckpointManager(ckpt_dir).restore(
        int(step_name.split('-')[-1]), map_location='cpu')
    model.load_state_dict(state['ema_params'])
    del state
    model.eval()

    vae = None
    if args.vae:
        from fitv2_tpu_torch.vae import AutoencoderKL, load_vae_state_dict
        vae = AutoencoderKL()
        vae.load_state_dict(load_vae_state_dict(args.vae))
        # bf16 decoder convolutions; GroupNorm statistics stay fp32
        vae = vae.to(device=device, dtype=torch.bfloat16).eval()

    fn = sampler_fn(model, args)
    B = args.per_device_batch
    n_tok = model.n_patch_h * model.n_patch_w
    token_dim = model.patch_size ** 2 * model.in_channels
    start_tok = n_tok // 16 if args.sampler == 'multiscale' else n_tok
    lat_hw = (model.n_patch_h * model.patch_size,
              model.n_patch_w * model.patch_size)
    out, batch_secs = [], []
    n_batches = int(np.ceil(args.num_fid_samples / B))
    t0 = time.perf_counter()
    with torch.no_grad():
        for bi in range(n_batches):
            t_batch = time.perf_counter()
            y, z, gen = batch_inputs(args.global_seed, bi, B, start_tok,
                                     token_dim, model.num_classes)
            tokens = fn(z.to(device), y.to(device), gen)
            lat = model.unpatchify(tokens, lat_hw, channel_last=True)
            if vae is not None:
                lat = images_to_uint8(vae.decode(
                    lat.to(torch.bfloat16) / 0.18215))
            out.append(lat.cpu().numpy())  # the copy waits for the device
            batch_secs.append(time.perf_counter() - t_batch)
    images = np.concatenate(out)[:args.num_fid_samples]
    save_npz(args.out, images)
    secs = time.perf_counter() - t0
    print(f'sampled {len(images)} in {secs:.3f} s '
          f'({len(images) / secs:.4f} images/s); a batch of {B}: median '
          f'{np.median(batch_secs):.3f} s, {min(batch_secs):.3f}-'
          f'{max(batch_secs):.3f} s')
    print(f'Saved {args.out} [shape={images.shape}]')


if __name__ == '__main__':
    main()
