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
within one call). Each run's rate is the wall time of steps TRAIN_TIMED + 1
to 2 TRAIN_TIMED, from a sync to a sync, loader included. Prints the card's
name and power limit, a line a run, then one JSON line.
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


def main() -> None:
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)
    # cuBLAS's deterministic kernels need a fixed workspace, set before the
    # library starts (as chip_smoke.main does)
    os.environ.setdefault('CUBLAS_WORKSPACE_CONFIG', ':4096:8')
    import chip_smoke as smoke  # imports no fitv2_tpu_torch at module level
    card = smoke.phase_device()
    smoke.phase_build()
    import torch
    from fitv2_tpu_torch.cli import train as cli
    from fitv2_tpu_torch.data import make_synthetic_latent_shards
    from fitv2_tpu_torch.utils import load_config
    timed = smoke.TRAIN_TIMED
    rates = []
    with tempfile.TemporaryDirectory() as out_dir:
        shards = os.path.join(out_dir, 'latents')
        make_synthetic_latent_shards(shards, n=smoke.TRAIN_SHARDS,
                                     target_len=smoke.N, seed=smoke.SEED)
        cfg = load_config(['configs/fitv2_xl.yaml'])
        cfg['data']['params']['train']['data_path'] = shards
        for i, (deterministic, every) in enumerate(SETTINGS):
            every = every or timed
            args = cli.parse_args([
                '--cfgdir', 'configs/fitv2_xl.yaml', '--output-dir',
                os.path.join(out_dir, f'run{i}'), '--max-steps',
                str(2 * timed), '--device', 'cuda'])
            torch.use_deterministic_algorithms(deterministic)
            try:
                _, _, _, stamps, _, _, _ = smoke._train_run(
                    cli, cfg, args, False, log_every=every, write=False)
            finally:
                torch.use_deterministic_algorithms(False)
            ms = (stamps[2 * timed] - stamps[timed]) * 1e3 / timed
            rates.append(dict(deterministic=deterministic, read_every=every,
                              ms_per_step=ms,
                              images_per_s=smoke.TRAIN_BATCH / ms * 1e3))
            print(f'run {i}: deterministic {deterministic}, metrics read '
                  f'every {every} steps: {ms:.2f} ms a step', flush=True)
            torch.cuda.empty_cache()
    print(json.dumps({'card': card, 'steps': [timed + 1, 2 * timed],
                      'runs': rates}), flush=True)


if __name__ == '__main__':
    main()
