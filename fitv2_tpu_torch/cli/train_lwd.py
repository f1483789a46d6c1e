"""CLI: LwD / BFM training with the PyTorch port, on one device or data
parallel under torchrun.

Usage:
    python -m fitv2_tpu_torch.cli.train_lwd \
        --cfgdir configs/fitv2_xl_lwd.yaml \
        [--distillation --teacher-ckpt teacher.safetensors \
         [--teacher-config fit.yaml] [--teacher-cfg-scale S]] \
        [--multi-scale [--multi-scale-indices 2 7]] \
        [--finetune replace|residual|blend] [--max-steps N] \
        [--output-dir DIR] [--no-resume] [--device cuda]

The flags are those of ``fitv2_tpu.cli.train_lwd`` plus ``--device``
(default ``cuda``). Recipes: reflow + REPA (default), ``--distillation``
(targets from rolling a frozen FiT teacher, read from a reference-layout
checkpoint; a ``--teacher-cfg-scale`` above 0 guides it with the null
class), ``--multi-scale`` and ``--finetune MODE``. The network is
built in fp32 on the CPU, moved to the device, and trains in its config's
``dtype`` (a merged YAML with ``dtype: bfloat16`` computes in bf16 over
fp32 masters, moments and EMA). The batches come from the shards at the
YAML's data path. The checkpoints are the port's
(``checkpoint-{step}/train_state.pt``), whose ``ema_params``
``cli/sample_lwd`` samples.

Data parallel: ``torchrun --nproc_per_node N -m fitv2_tpu_torch.cli.
train_lwd ...`` runs N processes, one card each (gloo where they share a
card); the YAML's batch is each process's, so the global batch is N
times it, as JAX's per-host batch.
"""

from __future__ import annotations

import argparse
import logging


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='LwD/BFM training (PyTorch)')
    p.add_argument('--cfgdir', nargs='+', required=True,
                   help='YAML config(s), merged left to right')
    p.add_argument('--output-dir', default=None)
    p.add_argument('--max-steps', type=int, default=None)
    p.add_argument('--seed', type=int, default=None)
    p.add_argument('--resume', action='store_true', default=True)
    p.add_argument('--no-resume', dest='resume', action='store_false')
    p.add_argument('--distillation', action='store_true',
                   help='distill from a frozen teacher FiT')
    p.add_argument('--teacher-ckpt', default=None,
                   help='the teacher: a reference-layout safetensors/bin '
                        'state dict')
    p.add_argument('--teacher-config', nargs='+', default=None,
                   help="the teacher's network YAML (default: "
                        'distillation_network_config in --cfgdir)')
    p.add_argument('--teacher-cfg-scale', type=float, default=0.0,
                   help='CFG scale while rolling the teacher (0 = off)')
    p.add_argument('--multi-scale', action='store_true',
                   help='multi-scale tier training')
    p.add_argument('--multi-scale-indices', type=int, nargs='+',
                   default=None, help='segment indices starting new tiers '
                                      '(default from config or (2, 7))')
    p.add_argument('--finetune', default=None,
                   choices=['replace', 'residual', 'blend'],
                   help='mid-block forecaster finetuning mode')
    p.add_argument('--repa-weight', type=float, default=None,
                   help='REPA alignment weight (reference 0.5)')
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def build_teacher_apply(args, cfg, device):
    """The frozen teacher's velocity ``teacher_apply(x, t, batch)`` (float32):
    a FiT from ``--teacher-config`` (or the config's
    ``distillation_network_config``) on ``device``, its weights read from
    ``--teacher-ckpt``."""
    import torch

    from fitv2_tpu_torch.ckpt import load_fit_checkpoint
    from fitv2_tpu_torch.models import FiT
    from fitv2_tpu_torch.utils.config import config_to_model, load_config

    if args.teacher_config:
        net = load_config(args.teacher_config)['diffusion']['network_config']
    else:
        net = (cfg['diffusion'].get('distillation_network_config')
               or cfg['diffusion']['network_config'])
    teacher = config_to_model(net)
    if not isinstance(teacher, FiT):
        raise ValueError(f'the teacher must be a FiT, not '
                         f'{type(teacher).__name__} (--teacher-config)')
    load_fit_checkpoint(args.teacher_ckpt, teacher)
    teacher = teacher.to(device).eval().requires_grad_(False)
    scale = args.teacher_cfg_scale

    def teacher_apply(x, t, batch):
        size = batch.get('size')
        if scale > 0:  # CFG on the doubled batch, the null class second
            def dup(a):
                return torch.cat([a, a])
            y2 = torch.cat([batch['label'], torch.full_like(
                batch['label'], teacher.num_classes)])
            out = teacher(dup(x), dup(t), y2, dup(batch['grid']),
                          dup(batch['mask']),
                          dup(size) if size is not None else None)
            cond, uncond = out.chunk(2, dim=0)
            return (uncond + scale * (cond - uncond)).float()
        return teacher(x, t, batch['label'], batch['grid'], batch['mask'],
                       size).float()

    return teacher_apply


def build_trainer(cfg, args):
    """The ``LwDTrainer`` that ``cfg`` (a loaded YAML dict) and ``args``
    describe."""
    import torch

    from fitv2_tpu_torch.parallel import process_count
    from fitv2_tpu_torch.train.lwd_trainer import LwDTrainer, LwDTrainerConfig
    from fitv2_tpu_torch.utils.config import config_to_model

    net = cfg['diffusion']['network_config']
    params = net.get('params') or {}
    dtype = params.get('dtype', 'float32')
    # initialised on the CPU, so that one seed gives one model on any device
    model = config_to_model(net, dtype=torch.float32)
    acc = cfg.get('accelerate', {})
    data = cfg.get('data', {}).get('params', {}).get('train', {})
    loader_cfg = data.get('loader', {})
    tc = LwDTrainerConfig(
        data_path=data.get('data_path', ''),
        target_len=int(data.get('target_len', 256)),
        random_mode=data.get('random', 'random'),
        global_batch_size=(int(loader_cfg.get('batch_size', 16))
                           * process_count()),  # the batch is per process
        num_workers=int(loader_cfg.get('num_workers', 4)),
        max_steps=args.max_steps or int(acc.get('max_train_steps', 400_000)),
        learning_rate=float(acc.get('learning_rate', 1e-4)),
        max_grad_norm=float(acc.get('max_grad_norm', 1.0)),
        repa_weight=(args.repa_weight if args.repa_weight is not None
                     else float(acc.get('repa_weight', 0.5))),
        seed=args.seed if args.seed is not None else int(
            acc.get('seed', 42)),
        output_dir=args.output_dir or acc.get('output_dir', 'runs/lwd'),
        checkpointing_steps=int(acc.get('checkpointing_steps', 4000)),
        checkpoints_total_limit=acc.get('checkpoints_total_limit', 4),
        mesh_fsdp=int(acc.get('mesh_fsdp', 1)),
        mesh_tensor=int(acc.get('mesh_tensor', 1)),
        dtype=str(dtype).replace('torch.', ''),
        device=args.device)
    teacher_apply = None
    if args.distillation:
        if not args.teacher_ckpt:
            raise SystemExit('--distillation needs --teacher-ckpt')
        teacher_apply = build_teacher_apply(args, cfg, args.device)
    recipe = 'reflow'
    if args.multi_scale:
        recipe = 'multiscale'
    elif args.finetune:
        recipe = 'finetune'
    ms = tuple(args.multi_scale_indices
               or params.get('multi_scale_indices', (2, 7)))
    return LwDTrainer(model, tc, teacher_apply=teacher_apply, recipe=recipe,
                      finetune_mode=args.finetune or 'replace',
                      multi_scale_indices=ms)


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
