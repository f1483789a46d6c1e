"""CLI: FiT training with the PyTorch port, on one device or data parallel
under torchrun.

Usage:
    python -m fitv2_tpu_torch.cli.train --cfgdir configs/fitv2_xl.yaml \
        [--no-resume] [--output-dir runs/xl] [--max-steps N] [--seed S] \
        [--device cuda]

The flags are those of ``fitv2_tpu.cli.train`` plus ``--device`` (default
``cuda``). The YAML sections are the same: ``diffusion`` (the network and
its transport, or FiTv1's ``diffusion_steps``), ``data.params.train``
(shards, target length, per-host batch) and ``accelerate`` (optimizer,
schedule, checkpoints). A ``learn_sigma`` network (FiTv1,
configs/fit_xl.yaml) trains the improved-diffusion ``ddpm`` objective,
any other the flow objective. ``--came`` or a CAME optimizer target trains
with CAME (train/came.py), as in JAX.

Data parallel: ``torchrun --nproc_per_node N -m fitv2_tpu_torch.cli.train
...`` runs N processes, one card each (gloo where they share a card); the
YAML's batch is each process's, so the global batch is N times it, as
JAX's per-host batch. The ``accelerate`` section's ``mesh_stage``,
``mesh_fsdp``, ``mesh_tensor`` and ``pp_microbatches`` (JAX's keys) and
``mesh_sequence`` (the port's addition: no config sets it; an override
YAML sets it to split HR-3B's 1024 tokens, configs/fitv2_hr_3b.yaml)
shard the model over those N processes (train/trainer.py); the data
axis takes what they leave. Overrides come through a second
``--cfgdir`` YAML, e.g. one holding ``accelerate: {mesh_fsdp: 2}``.
"""

from __future__ import annotations

import argparse
import logging


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='FiT training (PyTorch)')
    p.add_argument('--cfgdir', nargs='+', required=True,
                   help='YAML config(s), merged left to right')
    p.add_argument('--output-dir', default=None)
    p.add_argument('--resume', action='store_true', default=True)
    p.add_argument('--no-resume', dest='resume', action='store_false')
    p.add_argument('--max-steps', type=int, default=None)
    p.add_argument('--seed', type=int, default=None)
    p.add_argument('--came', action='store_true',
                   help='train with the CAME optimizer')
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def build_trainer(cfg, args):
    """The ``Trainer`` that ``cfg`` (a loaded YAML dict) and ``args``
    describe."""
    from fitv2_tpu_torch.flow import create_transport
    from fitv2_tpu_torch.parallel import process_count
    from fitv2_tpu_torch.train.trainer import Trainer, TrainerConfig
    from fitv2_tpu_torch.utils import config_to_model

    diff = cfg['diffusion']
    acc = cfg.get('accelerate', {})
    opt_target = str(acc.get('optimizer', {}).get('target', ''))
    model = config_to_model(diff['network_config'])
    tcfg = diff.get('transport', {})
    transport = create_transport(
        tcfg.get('path_type', 'Linear'), tcfg.get('prediction', 'velocity'),
        snr_type=tcfg.get('snr_type', 'lognorm'))
    net_params = diff['network_config'].get('params', {})
    objective = 'ddpm' if net_params.get('learn_sigma') else 'flow'

    data = cfg.get('data', {}).get('params', {}).get('train', {})
    loader_cfg = data.get('loader', {})
    opt = acc.get('optimizer', {}).get('params', {})
    tc = TrainerConfig(
        data_path=data.get('data_path', ''),
        target_len=int(data.get('target_len', 256)),
        random_mode=data.get('random', 'random'),
        global_batch_size=(int(loader_cfg.get('batch_size', 16))
                           * process_count()),  # the batch is per process
        num_workers=int(loader_cfg.get('num_workers', 8)),
        max_steps=args.max_steps or int(acc.get('max_train_steps',
                                                2_000_000)),
        learning_rate=float(acc.get('learning_rate', 1e-4)),
        scale_lr=bool(acc.get('learning_rate_base_batch_size', 0)),
        lr_schedule=acc.get('lr_scheduler', 'constant_with_warmup'),
        lr_warmup_steps=int(acc.get('lr_warmup_steps', 1000)),
        max_grad_norm=float(acc.get('max_grad_norm', 1.0)),
        weight_decay=float(opt.get('weight_decay', 0.0)),
        optimizer=('came' if args.came or 'came' in opt_target.lower()
                   else 'adamw'),
        grad_accum_steps=int(acc.get('gradient_accumulation_steps', 1)),
        seed=args.seed if args.seed is not None else int(
            acc.get('seed', 42)),
        output_dir=args.output_dir or acc.get('output_dir', 'runs/fitv2'),
        checkpointing_steps=int(acc.get('checkpointing_steps', 4000)),
        checkpoints_total_limit=acc.get('checkpoints_total_limit', 4),
        milestone_steps=tuple(acc.get('checkpointing_steps_list', ()) or ()),
        mesh_stage=int(acc.get('mesh_stage', 1)),
        mesh_fsdp=int(acc.get('mesh_fsdp', 1)),
        mesh_sequence=int(acc.get('mesh_sequence', 1)),
        mesh_tensor=int(acc.get('mesh_tensor', 1)),
        pp_microbatches=int(acc.get('pp_microbatches', 4)),
        objective=objective,
        diffusion_steps=int(diff.get('diffusion_steps', 1000)),
        device=args.device,
    )
    return Trainer(model, tc, transport=transport)


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)
    from fitv2_tpu_torch.parallel import init_distributed
    from fitv2_tpu_torch.utils.config import load_config
    init_distributed(args.device)
    trainer = build_trainer(load_config(args.cfgdir), args)
    trainer.train(max_steps=args.max_steps, resume=args.resume)


if __name__ == '__main__':
    main()
