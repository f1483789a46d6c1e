#!/usr/bin/env python3
"""Where the time of one sampler step of the PyTorch port goes, on one H100.

Run from the repository root on a machine with the card:

    python3 tools/torch_profile_step.py [--path bf16|int8|fused|hr] [--tree DIR]

Builds chip_smoke.py's FiTv2-XL/2 (random weights from its seed, the
zero-init leaves perturbed) in bf16 on the card (``--path int8``: the int8
W8A8 model on the same weights, calibrated by the sampler; ``--path
fused``: ``attn_impl='fused'`` on chip_smoke.py's padded 160x320 bucket,
200 of 256 tokens valid; ``--path hr``: the same weights as FiTv2-HR-XL/2,
online decoupled NTK RoPE, at 512x512 (1024 tokens) and chip_smoke.py's HR
batch), at chip_smoke.py's batch and CFG scale (256x256 unless fused or
hr), warms the sampler up, then measures:

- wall ms per step: three unprofiled STEPS-step sampler calls, each ended
  by ``torch.cuda.synchronize()``;
- device busy ms per step (kernels and copies), kernel launches per step
  and device ms and count per step of each group (the port's kernels by
  name, cuBLAS, copies, the rest): ``torch.profiler`` over one more
  STEPS-step call.

``--tree`` imports ``fitv2_tpu_torch`` from another checkout (for example
the parent commit unpacked by ``git archive``), so that two versions can be
compared on one card in one call; the model's definition stays this
checkout's chip_smoke.py. Prints the card's name and power limit, then one
JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 10

# kernel name fragment -> group; the first match wins
GROUPS = (('fused_attention_', 'fused_attention (K5)'),
          ('attention_', 'attention (K3/K4)'),
          ('adaln_kernel', 'adaln (K1)'),
          ('qk_rope_kernel', 'qk_rope (K2)'),
          ('int8_gemm_wgmma', 'int8_gemm_bias (K6)'),
          ('int8_gemm_swiglu', 'int8_gemm_swiglu_quant (K7)'),
          ('nvjet', 'cuBLAS'), ('gemm', 'cuBLAS'), ('cutlass', 'cuBLAS'),
          ('sm90_xmma', 'cuBLAS'))


def group_of(name: str) -> str:
    return next((g for frag, g in GROUPS if frag in name),
                'elementwise and other')


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--path', choices=('bf16', 'int8', 'fused', 'hr'),
                    default='bf16')
    ap.add_argument('--tree', default=ROOT)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import chip_smoke  # imports no fitv2_tpu_torch at module level
    sys.path.insert(0, os.path.abspath(args.tree))
    import torch
    card = chip_smoke.phase_device()
    import fitv2_tpu_torch
    from fitv2_tpu_torch.sample import SamplingConfig, build_sampler

    if args.path == 'hr':
        model = chip_smoke.hr_model_bf16()
        hw, batch, n_ctx = (512, 512), chip_smoke.HR_BATCH, chip_smoke.HR_N
    else:
        options = {'bf16': {}, 'int8': dict(gemm_precision='int8'),
                   'fused': dict(attn_impl='fused')}[args.path]
        model = chip_smoke.xl_model_bf16(**options)
        hw = chip_smoke.PADDED_HW if args.path == 'fused' else (256, 256)
        batch, n_ctx = chip_smoke.BATCH, 256
    labels = torch.arange(batch) * 111 % 1000
    z = torch.randn(batch, n_ctx, 16, generator=torch.Generator().manual_seed(
        chip_smoke.SEED + 3))
    scfg = SamplingConfig(image_height=hw[0], image_width=hw[1],
                          num_sampling_steps=STEPS,
                          cfg_scale=chip_smoke.CFG_SCALE,
                          per_device_batch=batch, dtype=torch.bfloat16,
                          **({'interpolation': 'keep'} if args.path == 'hr'
                             else {}))
    sample = build_sampler(model, scfg)  # int8: calibrates here
    sample(labels, z=z)  # warm-up
    torch.cuda.synchronize()

    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        sample(labels, z=z)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3 / STEPS)

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sample(labels, z=z)
        torch.cuda.synchronize()
    groups: dict[str, list[float]] = {}
    launches = 0
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        copy = 'Memcpy' in evt.name or 'Memset' in evt.name
        launches += not copy
        ms_count = groups.setdefault(
            'memcpy and memset' if copy else group_of(evt.name), [0.0, 0])
        ms_count[0] += evt.time_range.elapsed_us() / 1e3
        ms_count[1] += 1
    busy = sum(ms for ms, _ in groups.values()) / STEPS
    print(json.dumps({
        'path': args.path, 'tree': os.path.abspath(args.tree),
        'package': os.path.dirname(fitv2_tpu_torch.__file__),
        'card': card, 'steps': STEPS,
        'wall_ms_per_step': walls,
        'device_busy_ms_per_step': busy,
        'idle_share': [1 - busy / w for w in walls],
        'launches_per_step': launches / STEPS,
        'groups_ms_per_step': {
            g: [ms / STEPS, n / STEPS] for g, (ms, n) in
            sorted(groups.items(), key=lambda kv: -kv[1][0])},
    }), flush=True)


if __name__ == '__main__':
    main()
