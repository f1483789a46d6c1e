#!/usr/bin/env python3
"""The port's K5 (fused qk-LN + RoPE + attention, csrc/fused_attention.cu)
and K7 (int8 SwiGLU GEMM + requantization, csrc/int8_gemm.cu) against their
plain versions and the card's bound, at the XL sampler's shapes, on one
H100.

Run from the repository root on a machine with the card:

    python3 tools/torch_k5_k7_bench.py [--tree DIR]

K5: chip_smoke.py's _fused_attention_case on the flat (B, N, 3C) qkv of
XL/2 (CFG batch 16, N 256, H 16, Dh 72) in bf16 with the first 200 of 256
tokens valid (the fused path's padded 160x320 bucket) and with none
padded, in fp32 with the mask, and at small_cifar's Dh 32 (N 64, H 4, 48
valid) where the package builds that head dim: the kernel and the plain
version checked, then the kernel's, the plain version's and the unfused
pair's (K2 + K4 on the same qkv) median device times beside the bound.
K7: chip_smoke.py's _k7_site at the int8 path's fc1, M 4096 (the CFG
batch) and 2048 (conditional only), K 1152, 2H 6144.

``--tree`` imports ``fitv2_tpu_torch`` from another checkout (for example
the parent commit unpacked by ``git archive``), so that two versions can be
compared on one card in one call; the cases stay this checkout's. Prints
the card's name and power limit, then one JSON line a case.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
    from fitv2_tpu_torch.kernels.flash_attention import HEAD_DIMS
    package = os.path.dirname(fitv2_tpu_torch.__file__)
    gen = torch.Generator(device='cuda').manual_seed(chip_smoke.SEED)
    b = 2 * chip_smoke.BATCH

    def emit(kernel, case):
        print(json.dumps(dict(kernel=kernel, card=card, package=package,
                              **case)), flush=True)

    # (N, H, Dh, valid tokens of the masked case, dtypes)
    shapes = [(chip_smoke.N, chip_smoke.H, chip_smoke.DH, chip_smoke.N_VALID,
               (torch.bfloat16, torch.float32)),
              (64, 4, 32, 48, (torch.bfloat16,))]
    for n, h, dh, valid, dtypes in shapes:
        if dh not in HEAD_DIMS:
            print(f'Dh {dh}: not built by {package} (HEAD_DIMS {HEAD_DIMS});'
                  ' skipped', flush=True)
            continue
        qkv = torch.randn(b, n, 3 * h * dh, device='cuda', generator=gen)
        ang = torch.rand(b, n, dh, device='cuda', generator=gen) * 6.3
        cos, sin = torch.cos(ang), torch.sin(ang)
        mask = torch.zeros(b, n, device='cuda')
        mask[:, :valid] = 1.0
        for dtype in dtypes:
            masks = (mask, None) if dtype == torch.bfloat16 else (mask,)
            for m in masks:
                emit('fused_attention', chip_smoke._fused_attention_case(
                    K, qkv.to(dtype), cos, sin, m, h))
    for m_rows in (b * chip_smoke.N, chip_smoke.BATCH * chip_smoke.N):
        emit('int8_gemm_swiglu_quant', chip_smoke._k7_site(
            K, 'cuda', gen, m_rows, chip_smoke.D, 3072))


if __name__ == '__main__':
    main()
