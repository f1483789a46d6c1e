#!/usr/bin/env python3
"""The port's K1 (csrc/adaln.cu) and K2 (csrc/qk_rope.cu) against their
plain versions and the card's bound, at the widths of every model config in
configs/, on one H100.

Run from the repository root on a machine with the card:

    python3 tools/torch_norm_bench.py [--tree DIR]

A config gives D = hidden_size and (H, Dh) = (num_heads, hidden_size /
num_heads); the batch is chip_smoke.py's CFG batch (2 x its BATCH), at
N = 256 and 1024. For each shape and dtype (bf16, fp32), x with a large
common offset and shift/scale column chunks of a (B, 6D) modulation, q and
k column blocks of a (B, N, 3, H, Dh) qkv, as a FiT block hands them over:
chip_smoke.py's _adaln_case and _qk_rope_case check the kernel against the
plain version and take its median device time L2-warm, L2-cold (a 128 MiB
write and a 128 MiB read between the calls) and after the write alone,
beside the bound. The first JSON line is the launch floor: the same timing
of K1 on a single 128-wide row, which every single-call time includes.
Prints the card's name and power limit, then one JSON line a case.

``--tree`` imports ``fitv2_tpu_torch`` from another checkout (for example
the parent commit unpacked by ``git archive``), so that two versions can be
compared on one card in one call; the cases stay this checkout's.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOKENS = (256, 1024)


def config_shapes() -> dict[tuple[int, int, int], list[str]]:
    """(D, H, Dh) -> the model configs in configs/ that have it."""
    from fitv2_tpu_torch.utils.config import load_config
    shapes: dict[tuple[int, int, int], list[str]] = {}
    for path in sorted(glob.glob(os.path.join(ROOT, 'configs', '*.yaml'))):
        net = load_config(path).get('diffusion', {}).get('network_config', {})
        p = net.get('params', {})
        if 'hidden_size' not in p or 'num_heads' not in p:
            continue
        d, h = p['hidden_size'], p['num_heads']
        shapes.setdefault((d, h, d // h), []).append(os.path.basename(path))
    return shapes


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--tree', default=ROOT)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import chip_smoke  # imports no fitv2_tpu_torch at module level
    sys.path.insert(0, os.path.abspath(args.tree))
    import torch
    card = chip_smoke.phase_device()
    import fitv2_tpu_torch
    from fitv2_tpu_torch import kernels as K
    package = os.path.dirname(fitv2_tpu_torch.__file__)
    gen = torch.Generator(device='cuda').manual_seed(chip_smoke.SEED)
    one = torch.randn(1, 1, 128, device='cuda', generator=gen).bfloat16()
    mod = torch.zeros(1, 256, device='cuda', dtype=torch.bfloat16)
    floor = chip_smoke._time_ms(
        lambda: K.fused_adaln_norm(one, mod[:, :128], mod[:, 128:]))
    print(json.dumps(dict(launch_floor_us=floor * 1e3, card=card,
                          package=package)), flush=True)
    b = 2 * chip_smoke.BATCH
    for (d, h, dh), configs in sorted(config_shapes().items()):
        for n in TOKENS:
            for dtype in (torch.bfloat16, torch.float32):
                x = (torch.randn(b, n, d, device='cuda', generator=gen) * 2
                     + 3).to(dtype)
                mod = (0.5 * torch.randn(b, 6 * d, device='cuda',
                                         generator=gen)).to(dtype)
                shift, scale = mod.chunk(6, dim=-1)[:2]
                cases = [('adaln', chip_smoke._adaln_case(
                    K, x, shift, scale, time_plain=False))]
                del x, mod
                q, k, _ = torch.randn(b, n, 3, h, dh, device='cuda',
                                      generator=gen).to(dtype).unbind(2)
                ang = torch.rand(b, n, dh, device='cuda', generator=gen) * 6.3
                cases.append(('qk_rope', chip_smoke._qk_rope_case(
                    K, q, k, torch.cos(ang), torch.sin(ang),
                    time_plain=False)))
                for kernel, case in cases:
                    print(json.dumps(dict(kernel=kernel, configs=configs,
                                          card=card, package=package,
                                          **case)), flush=True)


if __name__ == '__main__':
    main()
