#!/usr/bin/env python3
"""Whether FiTv2-HR-3B trains on one H100, under remat 'dots' and under
'dots_offload' (the saved products in pinned host memory).

Run from the repository root on a machine with the card:

    python3 tools/torch_offload_3b.py [--runs dots:16 dots_offload:16]
        [--steps 4]

Each run (POLICY:BATCH) is one child process: cli/train's build_trainer on
configs/fitv2_hr_3b.yaml (hidden 2304, depth 40, 24 heads, 1024 tokens,
AdamW with a bf16 first moment, bf16 compute over fp32 masters, seeded
random weights) with the policy as its remat and the batch as its
per-process batch, on one process: the config's ``mesh_fsdp: 8`` becomes
1. It reads synthetic latent shards padded to 1024 tokens (the native
loader) and takes ``--steps`` steps, a sync after each. It reports the ms
of each step from the third on (the loop runs the first unlogged, and the
first offload step pins the host pool), the peak device memory
(``torch.cuda.max_memory_allocated``) of the run and at the end of each
step's backward (a sync ends each backward, to read it), the bytes each
step's forward offloaded and the host memory pinned, or, where the card
runs out of memory, the step and the part of it (forward, backward,
update) that failed and the allocator's message. Prints the card's name
and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = 'configs/fitv2_hr_3b.yaml'


def child(policy: str, batch: int, steps: int, out_dir: str) -> dict:
    """One run (see the module docstring); its result."""
    import torch
    from fitv2_tpu_torch.cli import train as cli
    from fitv2_tpu_torch.data import make_synthetic_latent_shards
    from fitv2_tpu_torch.models import remat
    from fitv2_tpu_torch.utils import load_config
    cfg = load_config([CONFIG])
    shards = os.path.join(out_dir, 'latents')
    make_synthetic_latent_shards(shards, n=batch * steps, target_len=1024,
                                 seed=0)
    cfg['data']['params']['train']['data_path'] = shards
    cfg['data']['params']['train']['loader']['batch_size'] = batch
    cfg['diffusion']['network_config']['params']['remat_policy'] = policy
    cfg['accelerate']['mesh_fsdp'] = 1
    args = cli.parse_args(['--cfgdir', CONFIG, '--output-dir',
                           os.path.join(out_dir, 'run'), '--max-steps',
                           str(steps), '--no-resume', '--device', 'cuda'])
    torch.manual_seed(0)
    t0 = time.perf_counter()
    trainer = cli.build_trainer(cfg, args)
    trainer.cfg.log_every = 1
    trainer.ckpt.save = lambda step, state_dict: None  # no checkpoint
    model = trainer.model
    out = dict(policy=policy, batch=batch, tokens=1024, depth=model.depth,
               hidden=model.hidden_size,
               parameters=sum(p.numel() for p in trainer.master_model
                              .parameters()),
               build_s=time.perf_counter() - t0, step_ms=[], losses=[])
    if model.remat_policy != policy or model.dtype != torch.bfloat16:
        raise AssertionError(f'{policy}: the trainer computes under '
                             f'{model.remat_policy} in {model.dtype}')
    stamps = {}

    def hook(step, metrics):
        torch.cuda.synchronize()
        stamps[step] = time.perf_counter()
        if step - 1 in stamps:
            out['step_ms'].append((stamps[step] - stamps[step - 1]) * 1e3)
        out['losses'].append(metrics['loss'])

    phase, backward = ['forward'], torch.Tensor.backward
    out['backward_peak_bytes'], out['offloaded_bytes'] = [], []

    def tracked_backward(tensor, *a, **k):
        phase[0] = 'backward'
        backward(tensor, *a, **k)
        torch.cuda.synchronize()
        out['backward_peak_bytes'].append(torch.cuda.max_memory_allocated())
        out['offloaded_bytes'].append(remat.counts['d2h_bytes'])
        remat.reset_counts()
        phase[0] = 'update'

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    remat.reset_counts()
    torch.Tensor.backward = tracked_backward
    try:
        trainer.train(max_steps=steps, resume=False, metric_hook=hook)
        out['outcome'] = 'trained'
    except torch.cuda.OutOfMemoryError as err:
        out['outcome'] = 'out of memory'
        out['failed_at_step'] = len(out['step_ms']) + 1
        out['failed_in'] = phase[0]
        out['error'] = str(err).splitlines()[0]
    finally:
        torch.Tensor.backward = backward
    out['peak_bytes'] = torch.cuda.max_memory_allocated()
    out['pinned_bytes'] = remat.PINNED.reserved
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--runs', nargs='+',
                    default=['dots:16', 'dots_offload:16'],
                    help='POLICY:BATCH, one child process each')
    ap.add_argument('--steps', type=int, default=4)
    ap.add_argument('--child', nargs=3, metavar=('POLICY', 'BATCH', 'DIR'),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    if args.child:
        policy, batch, out_dir = args.child
        print(json.dumps(child(policy, int(batch), args.steps, out_dir)),
              flush=True)
        return
    import chip_smoke  # imports no fitv2_tpu_torch at module level
    card = chip_smoke.phase_device()
    runs = []
    for run in args.runs:
        policy, batch = run.split(':')
        with tempfile.TemporaryDirectory() as out_dir:
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), '--steps',
                 str(args.steps), '--child', policy, batch, out_dir],
                stdout=subprocess.PIPE, text=True, timeout=1800)
        lines = proc.stdout.splitlines()
        if proc.returncode != 0 or not lines:
            runs.append(dict(policy=policy, batch=int(batch),
                             outcome=f'exit {proc.returncode}'))
        else:
            runs.append(json.loads(lines[-1]))
        print(json.dumps(runs[-1]), flush=True)
    print(card, flush=True)
    print(json.dumps({'config': CONFIG, 'card': card, 'steps': args.steps,
                      'runs': runs}), flush=True)


if __name__ == '__main__':
    main()
