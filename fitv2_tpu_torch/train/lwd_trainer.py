"""LwD / BFM training loop, on one device or data parallel:
random-segment updates, EMA, rotating checkpoints, preemption.

Counterpart of fitv2_tpu/train/lwd_trainer.py: each batch takes
``segments_per_step`` segment updates, each on a segment drawn from
``SegmentSampler`` (numpy ``PCG64(seed)``, JAX's stream), by one of the
recipes of train/lwd_train_step.py (reflow + REPA; distillation when a
``teacher_apply`` is given; multi-scale; the mid-block finetune).

As JAX builds it, the optimizer is ``make_optimizer(OptimizerConfig(lr,
clip, weight_decay))``: a constant learning rate with no warmup (the
YAMLs' ``lr_warmup_steps`` is not read) and an fp32 first moment. The
given model, in fp32, holds the master parameters; with ``dtype`` other
than float32 (the model config's dtype) a copy in that dtype computes.
The loop itself (resume, logging, checkpoints, preemption) is
``trainer.train_loop``, which ``Trainer`` runs too: this trainer gives it
a batch's segment updates and the segment stream's replay. Under
``torchrun`` the processes are the data axis, as ``Trainer``'s: every
process draws the same segment stream, and the segment updates average
their gradients (train/train_step.make_step).

Differences from the JAX trainer, by design:
- the initial parameters are the given model's own;
- each segment update's draws come from a CPU generator seeded from
  (seed, state.step), and ``state.step`` counts segment updates, JAX's
  ``fold_in`` count; the checkpoint's step counts batches;
- a resumed run replays the segment stream by ``segments_per_step`` draws
  a batch already taken and starts the loader at the resume step, so it
  equals the uninterrupted run; JAX rebuilds both streams from their start
  and repeats its first segments and batches;
- a checkpoint that cannot be read raises.

``mesh_fsdp`` and ``mesh_tensor`` shard the model as ``Trainer``'s axes do
(parallel/sharding.py ``shard_model``; FSDP2 also hooks
``forward_run_layer`` and the finetune forward); the segment updates'
``required`` zero gradients go into FSDP2's reduce-scatter with the rest.
"""

from __future__ import annotations

import copy
import dataclasses
import os
from typing import Any, Callable, Dict, Optional

import torch

from fitv2_tpu_torch.ckpt.checkpoint import CheckpointManager
from fitv2_tpu_torch.parallel.mesh import (
    MeshConfig, broadcast_, build_mesh)
from fitv2_tpu_torch.parallel.sharding import shard_model
from fitv2_tpu_torch.train import lwd_train_step as steps
from fitv2_tpu_torch.train.train_step import (
    OptimizerConfig, TrainState, create_train_state)
from fitv2_tpu_torch.train.trainer import step_generator, train_loop

RECIPES = ('reflow', 'multiscale', 'finetune')


@dataclasses.dataclass
class LwDTrainerConfig:
    # data: the shards' loader; global_batch_size is split over the
    # processes
    data_path: str = ''
    target_len: int = 256
    random_mode: str = 'random'
    global_batch_size: int = 32
    num_workers: int = 8
    max_steps: int = 400_000
    learning_rate: float = 1e-4
    max_grad_norm: float = 1.0
    weight_decay: float = 0.0
    ema_decay: float = 0.9999
    repa_weight: float = 0.5
    segments_per_step: int = 3      # reference for_loop=3
    seed: int = 42
    output_dir: str = 'runs/lwd'
    checkpointing_steps: int = 4000
    checkpoints_total_limit: Optional[int] = 4
    log_every: int = 100
    # the JAX trainer's mesh axes: data spans the processes (-1: all of
    # them); fsdp and tensor shard the model
    mesh_data: int = -1
    mesh_fsdp: int = 1
    mesh_tensor: int = 1
    # write checkpoints from a background thread over a host copy
    async_checkpointing: bool = False
    # on SIGTERM/SIGINT: finish the batch, checkpoint, return (preempted);
    # data parallel, the processes agree on it every this many batches
    handle_preemption: bool = True
    preemption_sync_every: int = 16
    # the compute dtype (the model config's); masters, moments, EMA: fp32
    dtype: str = 'float32'
    device: str = 'cuda'


class LwDTrainer:
    def __init__(self, model, config: LwDTrainerConfig,
                 teacher_apply: Optional[Callable] = None,
                 distill_solver_steps: int = 8, recipe: str = 'reflow',
                 finetune_mode: str = 'replace',
                 multi_scale_indices=(2, 7), loader: Optional[Any] = None):
        """``recipe``: 'reflow' (with ``teacher_apply(x, t, batch) ->
        velocity``, distillation from the frozen teacher), 'multiscale'
        (tiers split at ``multi_scale_indices``) or 'finetune' (the
        forecaster of a shared-encoder model, ``finetune_mode``).
        ``loader``: an object with ``train_dataloader(batch_size,
        max_steps, resume_step, seed)``; default the shards at
        ``data_path``."""
        if recipe not in RECIPES:
            raise ValueError(f'unknown LwD recipe: {recipe!r}')
        self.cfg = config
        self.device = torch.device(config.device)
        if self.device.type == 'cuda' and not torch.cuda.is_available():
            raise RuntimeError(f'device {config.device!r}: no CUDA card; '
                               "pass device='cpu' to train on the CPU")
        self.mesh = build_mesh(MeshConfig(
            data=config.mesh_data, fsdp=config.mesh_fsdp,
            tensor=config.mesh_tensor), device_type=self.device.type)
        self.preempted = False
        self.master_model = model.to(self.device, torch.float32)
        dtype = getattr(torch, config.dtype)
        self.layout = None
        if self.mesh.shards_model:
            broadcast_(list(self.master_model.parameters()))
            self.model, self.layout = shard_model(
                self.master_model, self.mesh, dtype, forward_methods=(
                    'forward_run_layer', 'forward_run_layer_finetune'))
        else:
            self.model = (self.master_model if dtype == torch.float32
                          else copy.deepcopy(self.master_model).to(dtype))
        self.loader = loader
        self.ckpt = CheckpointManager(
            os.path.join(config.output_dir, 'checkpoints'),
            total_limit=config.checkpoints_total_limit,
            async_save=config.async_checkpointing)
        self.optimizer_config = OptimizerConfig(
            learning_rate=config.learning_rate,
            max_grad_norm=config.max_grad_norm,
            weight_decay=config.weight_decay)
        common = dict(max_grad_norm=config.max_grad_norm,
                      ema_decay=config.ema_decay, layout=self.layout)
        if teacher_apply is not None:
            self._train_step = steps.make_lwd_distill_step(
                self.model, teacher_apply, distill_solver_steps, **common)
        elif recipe == 'multiscale':
            self._train_step = steps.make_lwd_multiscale_train_step(
                self.model, multi_scale_indices=multi_scale_indices,
                **common)
        elif recipe == 'finetune':
            self._train_step = steps.make_lwd_finetune_step(
                self.model, mode=finetune_mode, **common)
        else:
            self._train_step = steps.make_lwd_train_step(
                self.model, repa_weight=config.repa_weight, **common)

    def init_state(self) -> TrainState:
        """A fresh state from the master model's current parameters."""
        return create_train_state(self.master_model, self.optimizer_config)

    def train(self, max_steps: Optional[int] = None, resume: bool = True,
              metric_hook: Optional[Callable[[int, Dict], None]] = None
              ) -> TrainState:
        """Train to ``max_steps`` batches (resuming from the latest
        checkpoint unless ``resume`` is False); returns the state. Metrics
        are the mean over a batch's segment updates. Checkpoints at every
        ``checkpointing_steps``, at ``max_steps`` and on preemption."""
        cfg = self.cfg
        segments = steps.SegmentSampler(self.model.number_of_perflow,
                                        cfg.seed)

        def replay(step):  # replayed, not advanced: integers() may reject
            for _ in range(cfg.segments_per_step * step):
                segments()

        def run_batch(state, batch):
            return [self._train_step(state, batch, segments(),
                                     step_generator(cfg.seed, state.step))[1]
                    for _ in range(cfg.segments_per_step)]

        def mean(per_segment):
            return {k: sum(float(ms[k]) / cfg.segments_per_step
                           for ms in per_segment) for k in per_segment[0]}

        return train_loop(self, run_batch, max_steps, resume, metric_hook,
                          on_start=replay, log_metrics=mean)
