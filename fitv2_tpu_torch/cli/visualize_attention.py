"""CLI: attention-map rollout of a FiT, written as a heatmap overlay.

Usage:
    python -m fitv2_tpu_torch.cli.visualize_attention --out DIR \
        [--cfgdir configs/fitv2_xl.yaml --ckpt model_ema.safetensors] \
        [--query 0] [--t 0.5] [--device cuda]

Builds the FiT with ``save_attention=True``, runs one forward on seeded
noise at time ``--t`` (class 0, the full token grid), rolls the per-block
maps out and writes the ``--query`` token's heatmap over a grey canvas as
``rollout_q{query}.png`` (or ``.npy`` where PIL is missing). ``--cfgdir``
and ``--ckpt`` load the model through the port's config and
reference-layout checkpoint loaders; without them a small seeded random
model shows the pipeline (the rollout of an untrained model). The flags
are those of examples/visualize_attention.py plus ``--device``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='FiT attention rollout')
    p.add_argument('--out', default='fit_attention')
    p.add_argument('--ckpt', default=None)
    p.add_argument('--cfgdir', nargs='+', default=None)
    p.add_argument('--query', type=int, default=0,
                   help='query token index for the heatmap')
    p.add_argument('--t', type=float, default=0.5)
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def build_model(args):
    """The save_attention FiT the flags describe, in fp32 on the CPU."""
    import torch
    from fitv2_tpu_torch.models import FiT
    if args.cfgdir:
        from fitv2_tpu_torch.ckpt import load_fit_checkpoint
        from fitv2_tpu_torch.utils.config import config_to_model, load_config
        cfg = load_config(args.cfgdir)
        model = config_to_model(cfg['diffusion']['network_config'],
                                save_attention=True, scan_blocks=False)
        if args.ckpt:
            load_fit_checkpoint(args.ckpt, model)
        return model
    torch.manual_seed(1)
    return FiT(context_size=64, patch_size=2, in_channels=4, hidden_size=128,
               depth=4, num_heads=4, num_classes=10, learn_sigma=False,
               use_sit=True, use_swiglu=True, max_cached_len=16,
               save_attention=True, scan_blocks=False)


def main(argv=None) -> str:
    """Writes the overlay; returns its path."""
    args = parse_args(argv)
    import torch

    from fitv2_tpu_torch.eval.attention_viz import (
        attention_rollout, overlay_heatmap, run_with_attention,
        token_heatmap)
    from fitv2_tpu_torch.models.grid_utils import make_grid_mask_size

    device = torch.device(args.device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('--device cuda but no CUDA device is available')
    model = build_model(args).to(device).eval()
    n_h = n_w = int(np.sqrt(model.context_size))
    grid, mask, size = make_grid_mask_size(1, n_h, n_w, model.context_size,
                                           device)
    token_dim = model.patch_size ** 2 * model.in_channels
    x = torch.randn((1, model.context_size, token_dim),
                    generator=torch.Generator().manual_seed(0)).to(device)
    t = torch.full((1,), args.t, device=device)
    y = torch.zeros((1,), dtype=torch.int64, device=device)
    _, maps = run_with_attention(model, x, t, y, grid, mask, size)
    print(f'captured {len(maps)} block attention maps, '
          f'shape {maps[0].shape}')
    hm = token_heatmap(attention_rollout(maps), (n_h, n_w),
                       query_index=args.query)
    os.makedirs(args.out, exist_ok=True)
    base = np.full((n_h * 16, n_w * 16, 3), 64, np.uint8)
    over = overlay_heatmap(base, hm[0])
    try:
        from PIL import Image
    except ImportError:
        path = os.path.join(args.out, f'rollout_q{args.query}.npy')
        np.save(path, over)
        print('PIL unavailable; wrote npy instead')
        return path
    path = os.path.join(args.out, f'rollout_q{args.query}.png')
    Image.fromarray(over).save(path)
    print('wrote', path)
    return path


if __name__ == '__main__':
    main()
