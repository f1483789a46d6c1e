#!/usr/bin/env python3
"""The port's training rate at XL/2 under each setting that chip_smoke.py's
phase 11 changes: deterministic algorithms on or off, and the metrics read
(a host sync) every step or every TRAIN_TIMED steps, on one H100.

Run from the repository root on a machine with the card:

    python3 tools/torch_train_rate.py

Builds the kernels as chip_smoke.py does, writes its TRAIN_SHARDS synthetic
latent shards (padded to 256 tokens), then runs chip_smoke.py's
``_train_run`` (cli/train.py's build_trainer on configs/fitv2_xl.yaml:
depth 36, batch 32, bf16 compute over fp32 masters, bf16 mu, fp32 EMA, the
native loader; no checkpoint written) five times, 2 TRAIN_TIMED steps
each, in the order below (the first setting again fourth, for the spread
within one call), each run in a child process of this script
(chip_smoke.py's ``_run_child``): a
deterministic run's child sets chip_smoke.py's DETERMINISTIC_ENV (cuBLAS's
fixed workspace, which cuBLAS reads once, when it starts, and which slows
the host side of every GEMM), the others run without it. Each run's rate
is the wall time of steps TRAIN_TIMED + 1 to 2 TRAIN_TIMED, from a sync to
a sync, loader included. Prints the card's name and power limit, a line a
run, then one JSON line.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (deterministic algorithms, read the metrics every `n` steps); None: every
# TRAIN_TIMED steps
SETTINGS = ((False, None), (False, 1), (True, None), (False, None),
            (True, 1))


def run(i: int, out_dir: str) -> None:
    """Child process: SETTINGS[i] on the shards in out_dir; prints one
    JSON line."""
    import chip_smoke as smoke  # imports no fitv2_tpu_torch at module level
    smoke.phase_device()
    import torch
    from fitv2_tpu_torch.cli import train as cli
    deterministic, every = SETTINGS[i]
    timed = smoke.TRAIN_TIMED
    every = every or timed
    cfg = smoke._train_config('configs/fitv2_xl.yaml', out_dir,
                              smoke.TRAIN_RESUME)
    args = cli.parse_args([
        '--cfgdir', 'configs/fitv2_xl.yaml', '--output-dir',
        os.path.join(out_dir, f'run{i}'), '--max-steps', str(2 * timed),
        '--device', 'cuda'])
    torch.use_deterministic_algorithms(deterministic)
    _, _, _, stamps, _, _, _ = smoke._train_run(
        cli, cfg, args, False, log_every=every, write=False)
    ms = (stamps[2 * timed] - stamps[timed]) * 1e3 / timed
    print(json.dumps(dict(deterministic=deterministic, read_every=every,
                          ms_per_step=ms,
                          images_per_s=smoke.TRAIN_BATCH / ms * 1e3)),
          flush=True)


def main() -> None:
    import chip_smoke as smoke
    card = smoke.phase_device()
    smoke.phase_build()
    from fitv2_tpu_torch.data import make_synthetic_latent_shards
    rates = []
    with tempfile.TemporaryDirectory() as out_dir:
        make_synthetic_latent_shards(os.path.join(out_dir, 'latents'),
                                     n=smoke.TRAIN_SHARDS,
                                     target_len=smoke.N, seed=smoke.SEED)
        for i, (deterministic, _) in enumerate(SETTINGS):
            rate = smoke._run_child(
                [os.path.abspath(__file__), '--run', str(i), out_dir],
                smoke.DETERMINISTIC_ENV if deterministic else {})
            rates.append(rate)
            print(f'run {i}: deterministic {deterministic}, metrics read '
                  f'every {rate["read_every"]} steps: '
                  f'{rate["ms_per_step"]:.2f} ms a step', flush=True)
    print(json.dumps({'card': card, 'steps': [smoke.TRAIN_TIMED + 1,
                                              2 * smoke.TRAIN_TIMED],
                      'runs': rates}), flush=True)


if __name__ == '__main__':
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)
    if len(sys.argv) == 4 and sys.argv[1] == '--run':
        run(int(sys.argv[2]), sys.argv[3])
    else:
        main()
