#!/usr/bin/env python3
"""The port's bf16 attention kernel (csrc/attention.cu) against torch's
scaled_dot_product_attention and the card's bound, at the attention shape
of every FiT config in configs/, on one H100.

Run from the repository root on a machine with the card:

    python3 tools/torch_attention_bench.py

A config gives (N, H, Dh) = (context_size, num_heads, hidden_size /
num_heads); the batch is chip_smoke.py's CFG batch (2 x its BATCH). A head
dim the kernel is not built for is named and skipped. For each shape and
each variant/mask case (bounded or online softmax; no mask or the first
200/256 of the keys valid), q and k LayerNormed per head (the
bounded-logit contract), v a column block of a (B, N, 3, H, Dh) qkv,
chip_smoke.py's _attention_case checks the kernel and
scaled_dot_product_attention against the plain version and takes both
median device times beside the bound. Prints the card's name and power
limit, then one JSON line a case.
"""

from __future__ import annotations

import glob
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def config_shapes() -> dict[tuple[int, int, int], list[str]]:
    """(N, H, Dh) -> the FiT configs in configs/ that have it."""
    from fitv2_tpu_torch.utils.config import FIT_TARGETS, load_config
    shapes: dict[tuple[int, int, int], list[str]] = {}
    for path in sorted(glob.glob(os.path.join(ROOT, 'configs', '*.yaml'))):
        net = load_config(path).get('diffusion', {}).get('network_config', {})
        if net.get('target') not in FIT_TARGETS:
            continue
        p = net['params']
        key = (p['context_size'], p['num_heads'],
               p['hidden_size'] // p['num_heads'])
        shapes.setdefault(key, []).append(os.path.basename(path))
    return shapes


def main() -> None:
    sys.path.insert(0, ROOT)
    import torch
    import torch.nn.functional as F
    import chip_smoke
    from fitv2_tpu_torch import kernels as K
    from fitv2_tpu_torch.kernels.flash_attention import HEAD_DIMS
    card = chip_smoke.phase_device()
    gen = torch.Generator(device='cuda').manual_seed(chip_smoke.SEED)
    b = 2 * chip_smoke.BATCH
    for (n, h, dh), configs in sorted(config_shapes().items()):
        if dh not in HEAD_DIMS:
            print(f'(N {n}, H {h}, Dh {dh}) of {configs}: head dim not built '
                  f'(HEAD_DIMS {HEAD_DIMS}); skipped', flush=True)
            continue
        qkv = torch.randn(b, n, 3, h, dh, device='cuda', generator=gen)
        qkv[:, :, :2] = F.layer_norm(qkv[:, :, :2], (dh,), eps=1e-6)
        q, k, v = qkv.bfloat16().unbind(2)
        mask = torch.zeros(b, n, device='cuda')
        mask[:, :n * 200 // 256] = 1.0
        for bounded in (True, False):
            for m in (None, mask):
                case = chip_smoke._attention_case(
                    K, torch.bfloat16, q, k, v, m, bounded, time_plain=False)
                print(json.dumps(dict(shape=[b, n, h, dh], configs=configs,
                                      card=card, **case)), flush=True)


if __name__ == '__main__':
    main()
