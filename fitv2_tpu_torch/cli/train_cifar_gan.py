"""CLI: GAN-guided LwD training on CIFAR-10 pixels, on one device.

Usage:
    python -m fitv2_tpu_torch.cli.train_cifar_gan --cifar DIR \
        [--steps 1000] [--batch 64] [--lr 1e-4] [--disc-start 200] \
        [--seed 0] [--device cuda]

The port's counterpart of examples/train_cifar_gan.py, with its flags plus
``--device`` (default ``cuda``). ``DIR`` holds ``cifar-10-batches-py/``.
A segmented FiTLwD student (hidden 384, depth 12, 6 heads, K = 4
segments, adaLN-LoRA 96) learns reflow targets in pixel space (32 x 32 x 3
-> 256 tokens of 2 x 2 x 3 patches); each step trains one segment, drawn
from ``SegmentSampler(4, seed)``, with the flow loss plus an adversarial
term from a PatchGAN discriminator (ndf 64, 3 layers, BatchNorm) that
judges the segment's one-step end estimate, clipped to [-1, 1]; then the
discriminator takes its hinge step on the real batch against that
estimate recomputed with the updated generator. The generator's optimizer
is the JAX package's default AdamW (clip 1, fp32 moments, EMA 0.9999),
the discriminator's Adam(lr, 0.5, 0.9); the adversarial term has weight
0.1 from the generator's step ``--disc-start`` on.

As in the example, every step takes the same draws (x0, r and the label
drops), from a CPU generator seeded from ``--seed`` anew for each
generator step and each recomputation. The networks are initialised on
the CPU from ``--seed`` (flax's initialisers) and moved to the device.
Every 50 steps a line ``step N: gen=... base=... d=...`` is printed.
``main`` returns the per-step losses and wall times.
"""

from __future__ import annotations

import argparse
import time

N_SIDE, PATCH, TOKENS = 16, 2, 256


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description='GAN-guided LwD training on CIFAR-10 (PyTorch)')
    p.add_argument('--cifar', required=True,
                   help='dir containing cifar-10-batches-py/')
    p.add_argument('--steps', type=int, default=1000)
    p.add_argument('--batch', type=int, default=64)
    p.add_argument('--lr', type=float, default=1e-4)
    p.add_argument('--disc-start', type=int, default=200)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def patchify(img):
    """(B, H, W, 3) -> (B, H W / 4, 12), each token a 2 x 2 x 3 patch in
    (c, p, q) order (CIFAR: 256 tokens)."""
    b, h, w, c = img.shape
    x = img.reshape(b, h // PATCH, PATCH, w // PATCH, PATCH, c)
    return x.permute(0, 1, 3, 5, 2, 4).reshape(
        b, h * w // PATCH ** 2, c * PATCH ** 2)


def unpatchify(tok, n_h: int = N_SIDE, n_w: int = N_SIDE):
    """The inverse of ``patchify`` on an n_h x n_w token grid."""
    b = tok.shape[0]
    x = tok.reshape(b, n_h, n_w, 3, PATCH, PATCH)
    return x.permute(0, 1, 4, 2, 5, 3).reshape(b, n_h * PATCH, n_w * PATCH,
                                               3)


def build_model():
    from fitv2_tpu_torch.models import FiTLwD
    return FiTLwD(context_size=TOKENS, patch_size=PATCH, in_channels=3,
                  hidden_size=384, depth=12, num_heads=6, num_classes=10,
                  number_of_perflow=4, n_patch_h=N_SIDE, n_patch_w=N_SIDE,
                  adaln_type='lora', adaln_lora_dim=96, max_cached_len=32)


def make_generator_loss(model, batch_size: int, device):
    """``gen_loss_fn(model, batch, generator, draws, segment_idx) ->
    (flow loss, fake images)``: segment k's reflow MSE on the batch's
    patches, and its one-step end estimate clipped to [-1, 1], on the
    model's full token grid."""
    import torch

    from fitv2_tpu_torch.models.grid_utils import make_grid_mask_size
    from fitv2_tpu_torch.train.lwd_train_step import (
        _segment_inputs, _x0_r)

    n_h, n_w = model.n_patch_h, model.n_patch_w
    grid, _, size = make_grid_mask_size(batch_size, n_h, n_w, n_h * n_w,
                                        device)
    sigmas = model.sigmas

    def gen_loss_fn(model, batch, generator, draws, segment_idx):
        k = segment_idx
        x1 = patchify(batch['image'])
        x0, r = _x0_r(x1.shape, x1, generator, draws)
        xt_in, xt, t_input, x_input = _segment_inputs(sigmas, k, x1, x0, r)
        ds = float(sigmas[k + 1]) - float(sigmas[k])
        target = (xt - xt_in) / ds
        # a full grid: the mask is statically absent (the same values)
        pred, _ = model.forward_run_layer(
            x_input, t_input, batch['label'], k, grid, None, size,
            train=True, force_drop_ids=(draws or {}).get('drop_ids'),
            generator=generator)
        flow_loss = torch.mean((pred.float() - target.float()) ** 2)
        fake = unpatchify(x_input + ds * pred, n_h, n_w)
        return flow_loss, torch.clamp(fake, -1, 1)
    return gen_loss_fn


def main(argv=None):
    args = parse_args(argv)
    import numpy as np
    import torch

    from fitv2_tpu_torch.data.imagenet import cifar10_loader
    from fitv2_tpu_torch.losses import (
        LPIPSWithDiscriminator2D, NLayerDiscriminator)
    from fitv2_tpu_torch.train import (
        OptimizerConfig, SegmentSampler, create_disc_state,
        create_train_state, disc_adam, make_gan_steps)
    from fitv2_tpu_torch.train.lwd_train_step import _segment_params

    device = torch.device(args.device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('--device cuda: no CUDA device is available')
    torch.manual_seed(args.seed)
    model = build_model()
    disc = NLayerDiscriminator(input_nc=3, ndf=64, n_layers=3)
    model.to(device).train()
    disc.to(device).train()
    B = args.batch
    state = create_train_state(model, OptimizerConfig(learning_rate=args.lr))
    disc_state = create_disc_state(
        disc, lambda params: disc_adam(params, args.lr))
    loss_cfg = LPIPSWithDiscriminator2D(disc_start=args.disc_start,
                                        disc_factor=1.0, disc_weight=0.1)
    gen_loss_fn = make_generator_loss(model, B, device)
    gen_step, disc_step = make_gan_steps(gen_loss_fn, model, loss_cfg,
                                         required=_segment_params(model))
    seg_sampler = SegmentSampler(model.number_of_perflow, seed=args.seed)

    def draws():  # the example's one key: the same draws every step
        return torch.Generator().manual_seed(args.seed)

    history = []
    loader = cifar10_loader(args.cifar, B, seed=args.seed)
    t_prev = time.perf_counter()
    for step, batch_np in enumerate(loader):
        if step >= args.steps:
            break
        batch = {'image': torch.from_numpy(batch_np['image']).to(device),
                 'label': torch.from_numpy(
                     batch_np['label'].astype(np.int64)).to(device)}
        seg = seg_sampler()
        state, gm = gen_step(state, disc_state, batch, draws(),
                             segment_idx=seg)
        with torch.no_grad():
            _, fake = gen_loss_fn(model, batch, draws(), None, seg)
        disc_state, dm = disc_step(disc_state, batch['image'], fake,
                                   state.step)
        rec = {'segment': seg,
               **{k: float(v) for k, v in gm.items()},
               'd_loss': float(dm['d_loss'])}
        now = time.perf_counter()
        rec['ms'] = (now - t_prev) * 1e3
        t_prev = now
        history.append(rec)
        if step % 50 == 0:
            print(f"step {step}: gen={rec['loss']:.4f} "
                  f"base={rec['base_loss']:.4f} d={rec['d_loss']:.4f}",
                  flush=True)
    print('done')
    return {'history': history, 'state': state, 'disc_state': disc_state,
            'model': model}


if __name__ == '__main__':
    main()
