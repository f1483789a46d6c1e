"""Config-driven FiT training loop, on one device or data parallel.

Counterpart of fitv2_tpu/train/trainer.py: the resumable data stream, the
train step (bf16 compute over fp32 master parameters, AdamW or CAME, EMA)
of the FiTv2 flow objective or the FiTv1 ``ddpm`` objective (improved
diffusion over ``diffusion_steps``), rotating checkpoints, metric logging
and the preemption guard, in one loop. Each process runs on one device,
``cuda`` unless the config asks for the CPU. Under ``torchrun``
(``parallel.init_distributed``) the processes are the mesh's data axis:
``global_batch_size`` is split evenly, each process loads its share of
every global batch (``shard_indices``), the gradients are averaged
(train/train_step.make_step), process 0 writes the checkpoints and every
process restores them, and a preemption signal on any process stops all
after the same step. The mesh's other axes shard the model
(parallel/sharding.py ``shard_model``: FSDP2, tensor, sequence, and the
GPipe stages with ``pp_microbatches`` a data shard): the batch is split
over data x fsdp, the ranks of a batch shard load the same rows and draw
alike, and the checkpoint holds the one-process layout whatever the mesh
(process 0 gathers it; every rank restores its shards from it), AdamW's
or CAME's state included. JAX's refusals hold: the pipeline takes the
flow objective only, composes with the data axis only, and needs a batch
that splits into the data shards x ``pp_microbatches``. An
``InlineEvalHook`` samples with ``one_process_model`` (a copy of the
model's structure taken before it is sharded) filled from
``gathered_ema()``.

Differences from the JAX trainer, by design:
- the initial parameters are the given model's own (the port initialises
  a FiT when it is built), and that model, in fp32, holds the master
  parameters; with ``mixed_precision='bf16'`` a bf16 copy computes;
- each micro-step's draws (t, x0 or the noise, label drops) come from a
  CPU generator seeded from (seed, step), so a resumed run replays the
  uninterrupted run's draws;
- a checkpoint that cannot be read raises; JAX starts afresh silently.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import logging
import os
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from fitv2_tpu_torch.ckpt.checkpoint import (
    CheckpointManager, latest_checkpoint_step)
from fitv2_tpu_torch.data.latent_dataset import INLatentLoader
from fitv2_tpu_torch.flow.transport import Transport, create_transport
from fitv2_tpu_torch.parallel.mesh import (
    MeshConfig, batch_sharding, broadcast_, build_mesh, process_count,
    process_index, sync_global_devices)
from fitv2_tpu_torch.parallel.sharding import check_axes, shard_model
from fitv2_tpu_torch.sched.gaussian_diffusion import create_diffusion
from fitv2_tpu_torch.train.ddpm_train_step import make_ddpm_train_step
from fitv2_tpu_torch.train.lr_scheduler import get_scheduler
from fitv2_tpu_torch.train.preemption import PreemptionGuard
from fitv2_tpu_torch.train.train_step import (
    OptimizerConfig, TrainState, create_train_state, make_train_step,
    scale_lr_by_global_batch)

logger = logging.getLogger('fitv2_tpu_torch.trainer')

_DTYPES = {'bf16': torch.bfloat16, 'no': torch.float32}


@dataclasses.dataclass
class TrainerConfig:
    # data
    data_path: str = ''
    target_len: int = 256
    random_mode: str = 'random'
    global_batch_size: int = 256
    num_workers: int = 8
    loader_backend: str = 'native'  # or 'python'
    # schedule and optimizer
    max_steps: int = 2_000_000
    learning_rate: float = 1e-4
    scale_lr: bool = False
    lr_schedule: str = 'constant_with_warmup'
    lr_warmup_steps: int = 1000
    max_grad_norm: float = 1.0
    weight_decay: float = 0.0
    grad_accum_steps: int = 1
    optimizer: str = 'adamw'  # or 'came'
    # Adam's first moment: bf16 halves that state; None keeps fp32
    mu_dtype: Optional[str] = 'bfloat16'
    ema_decay: float = 0.9999
    seed: int = 42
    # 'flow' (FiTv2) or 'ddpm' (FiTv1: improved diffusion, learned-range
    # variance for a learn_sigma model)
    objective: str = 'flow'
    diffusion_steps: int = 1000
    # transport
    path_type: str = 'Linear'
    prediction: str = 'velocity'
    snr_type: str = 'lognorm'
    # 'bf16': bf16 compute with fp32 masters, moments and EMA; 'no': fp32
    mixed_precision: str = 'bf16'
    device: str = 'cuda'
    # the JAX trainer's mesh axes: data spans the processes (-1: all of
    # them); stage > 1 runs GPipe with pp_microbatches a data shard
    mesh_data: int = -1
    mesh_stage: int = 1
    mesh_fsdp: int = 1
    mesh_sequence: int = 1
    mesh_tensor: int = 1
    pp_microbatches: int = 4
    # checkpoints and logging
    output_dir: str = 'runs/fitv2'
    checkpointing_steps: int = 4000
    checkpoints_total_limit: Optional[int] = 4
    milestone_steps: tuple = ()
    # write checkpoints from a background thread over a host copy
    async_checkpointing: bool = False
    # on SIGTERM/SIGINT: finish the step, checkpoint, return (preempted);
    # data parallel, the processes agree on it every this many steps
    handle_preemption: bool = True
    preemption_sync_every: int = 16
    log_every: int = 100


def _check_config(cfg: TrainerConfig) -> None:
    if cfg.objective not in ('flow', 'ddpm'):
        raise ValueError(f"objective={cfg.objective!r}: 'flow' or 'ddpm'")
    if cfg.optimizer not in ('adamw', 'came'):
        raise ValueError(f"optimizer={cfg.optimizer!r}: 'adamw' or 'came'")
    if cfg.mixed_precision not in _DTYPES:
        raise ValueError(f'mixed_precision={cfg.mixed_precision!r}: one of '
                         f'{sorted(_DTYPES)}')
    if cfg.mesh_stage > 1 and cfg.objective == 'ddpm':
        raise ValueError('pipeline parallelism supports the flow '
                         'objective only')


def skeleton(model: torch.nn.Module) -> torch.nn.Module:
    """A copy of ``model`` whose parameters lie on the meta device (it
    holds no memory for them): the one-process structure that a sampling
    copy is made from (``InlineEvalHook``)."""
    memo = {id(p): torch.nn.Parameter(torch.empty_like(p, device='meta'),
                                      requires_grad=False)
            for p in model.parameters()}
    return copy.deepcopy(model, memo)


def batch_to_device(batch_np: Dict[str, np.ndarray], device: torch.device
                    ) -> Dict[str, torch.Tensor]:
    """A loader's numpy batch as tensors on ``device``."""
    return {k: torch.from_numpy(np.asarray(v)).to(device, non_blocking=True)
            for k, v in batch_np.items()}


def step_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of micro-step ``step``'s draws."""
    state = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)
    return torch.Generator().manual_seed(int(state[0]))


class Trainer:
    def __init__(self, model, config: TrainerConfig,
                 transport: Optional[Transport] = None,
                 loader: Optional[Any] = None):
        if getattr(model, 'gemm_precision', 'bf16') == 'int8':
            # int8 rounding has no gradient: W8A8 is a serving mode only
            raise ValueError("gemm_precision='int8' is inference-only; "
                             'train in bf16 and quantize for serving')
        _check_config(config)
        self.cfg = config
        self.device = torch.device(config.device)
        if self.device.type == 'cuda' and not torch.cuda.is_available():
            raise RuntimeError(f'device {config.device!r}: no CUDA card; '
                               "pass device='cpu' to train on the CPU")
        self.mesh = build_mesh(MeshConfig(
            config.mesh_data, config.mesh_stage, config.mesh_fsdp,
            config.mesh_sequence, config.mesh_tensor),
            device_type=self.device.type)
        check_axes(self.mesh)
        if config.mesh_stage > 1:
            shards = batch_sharding(self.mesh)[1]
            if (config.global_batch_size % shards or
                    (config.global_batch_size // shards)
                    % config.pp_microbatches):
                raise ValueError(
                    f'global_batch_size={config.global_batch_size} must '
                    f'split into {shards} data shard(s) x '
                    f'pp_microbatches={config.pp_microbatches}')
        self.preempted = False
        self.transport = transport or create_transport(
            config.path_type, config.prediction, snr_type=config.snr_type)
        # the fp32 model holds the master parameters; a bf16 copy computes
        # (under fsdp: FSDP2's bf16 gathers of the fp32 shards)
        self.master_model = model.to(self.device, torch.float32)
        self.one_process_model = skeleton(self.master_model)
        dtype = _DTYPES[config.mixed_precision]
        self.layout = None
        if self.mesh.shards_model:
            # every rank starts from process 0's weights, then shards them
            broadcast_(list(self.master_model.parameters()))
            self.model, self.layout = shard_model(
                self.master_model, self.mesh, dtype,
                pp_microbatches=config.pp_microbatches)
        else:
            self.model = (self.master_model if dtype == torch.float32
                          else copy.deepcopy(self.master_model).to(dtype))
        self.loader = loader
        self.ckpt = CheckpointManager(
            os.path.join(config.output_dir, 'checkpoints'),
            total_limit=config.checkpoints_total_limit,
            milestone_steps=config.milestone_steps,
            async_save=config.async_checkpointing)
        lr = config.learning_rate
        if config.scale_lr:
            lr = scale_lr_by_global_batch(lr, config.global_batch_size)
        self.optimizer_config = OptimizerConfig(
            learning_rate=lr, max_grad_norm=config.max_grad_norm,
            weight_decay=config.weight_decay,
            grad_accum_steps=config.grad_accum_steps,
            optimizer=config.optimizer,
            mu_dtype=getattr(torch, config.mu_dtype) if config.mu_dtype
            else None,
            lr_schedule=get_scheduler(
                config.lr_schedule, lr,
                num_warmup_steps=config.lr_warmup_steps,
                num_training_steps=config.max_steps))
        if config.objective == 'ddpm':
            self.diffusion = create_diffusion(
                timestep_respacing='', diffusion_steps=config.diffusion_steps,
                learn_sigma=model.learn_sigma)
            self._train_step = make_ddpm_train_step(
                self.model, self.diffusion, config.max_grad_norm,
                config.ema_decay, layout=self.layout)
        else:
            self._train_step = make_train_step(
                self.model, self.transport, config.max_grad_norm,
                config.ema_decay, layout=self.layout)

    def init_state(self) -> TrainState:
        """A fresh state from the master model's current parameters."""
        return create_train_state(self.master_model, self.optimizer_config,
                                  layout=self.layout)

    def gathered_ema(self) -> Dict[str, torch.Tensor]:
        """The EMA of ``self.state`` in the one-process layout, by
        parameter name, whole on every rank: under model sharding a
        collective that every rank makes at the same steps."""
        ema = self.state.ema_params
        if self.layout is None:
            return ema
        return {n: self.layout.to_full(n, ema.get(n))
                for n in self.layout.names}

    def train(self, max_steps: Optional[int] = None, resume: bool = True,
              metric_hook: Optional[Callable[[int, Dict], None]] = None
              ) -> TrainState:
        """Train to ``max_steps`` (resuming from the latest checkpoint
        unless ``resume`` is False); returns the state. Checkpoints at every
        ``checkpointing_steps``, at ``max_steps`` and on preemption."""
        seed = self.cfg.seed

        def run_batch(state, batch):
            return self._train_step(state, batch,
                                    step_generator(seed, state.step))[1]

        # the first batch runs before the loop, as in the JAX trainer
        return train_loop(self, run_batch, max_steps, resume, metric_hook,
                          loader_backend=self.cfg.loader_backend,
                          check_first=False)


def _scalar_metrics(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    # vector metrics (ddpm's per_t_loss and t) stay out
    return {k: float(v) for k, v in metrics.items() if v.dim() == 0}


def train_loop(trainer, run_batch: Callable[[TrainState, Dict], Any],
               max_steps: Optional[int] = None, resume: bool = True,
               metric_hook: Optional[Callable[[int, Dict], None]] = None, *,
               loader_backend: str = 'native',
               on_start: Optional[Callable[[int], None]] = None,
               log_metrics: Callable[[Any], Dict[str, float]] = (
                   _scalar_metrics),
               check_first: bool = True) -> TrainState:
    """The loop of ``Trainer`` and ``LwDTrainer`` over ``trainer``'s
    ``cfg``, ``loader``, ``ckpt``, ``device`` and ``init_state()``.

    The state comes from the latest checkpoint (unless ``resume`` is False)
    or ``init_state()``; ``on_start(step)`` then runs with the step resumed
    from, and the loader starts there. ``run_batch(state, batch)`` takes
    each batch (tensors on the device) and returns its metrics, which
    ``log_metrics`` turns into floats every ``log_every`` batches. With
    ``check_first`` False the first batch runs unlogged and unchecked.
    Checkpoints at every ``checkpointing_steps``, at ``max_steps`` and on
    preemption; an async save is whole when the loop returns. The state is
    ``trainer.state`` while the loop runs (an ``InlineEvalHook`` reads its
    EMA there). Data parallel, each process takes its share of every
    global batch (its loader gets ``process_index`` and
    ``process_count``), a fresh run starts from process 0's parameters,
    process 0 writes the checkpoints and a barrier follows each save.
    Under model sharding (``trainer.layout``) the shards are data x fsdp,
    the checkpoint is gathered into the one-process layout, and every rank
    restores its shards from it."""
    cfg = trainer.cfg
    max_steps = max_steps or cfg.max_steps
    layout = getattr(trainer, 'layout', None)
    rank, world = process_index(), process_count()
    shard_index, shards = batch_sharding(
        None if layout is None else layout.mesh)
    if cfg.global_batch_size % shards:
        raise ValueError(f'global_batch_size={cfg.global_batch_size} does '
                         f'not split into {shards} batch shards')
    if trainer.loader is None:
        trainer.loader = INLatentLoader(
            cfg.data_path, cfg.target_len, cfg.random_mode,
            batch_size=cfg.global_batch_size, num_workers=cfg.num_workers,
            backend=loader_backend)
    step = (latest_checkpoint_step(trainer.ckpt.ckpt_dir) or 0) if resume \
        else 0
    state = trainer.state = trainer.init_state()
    if step and layout is not None:
        layout.load_full_state_dict(state, trainer.ckpt.restore(
            step, map_location='cpu', mmap=True))
        logger.info('resumed from step %d', step)
    elif step:
        state.load_state_dict(trainer.ckpt.restore(
            step, map_location=trainer.device))
        logger.info('resumed from step %d', step)
    elif world > 1 and layout is None:
        # every process starts from process 0's parameters (a sharded
        # trainer broadcast them before sharding)
        broadcast_(list(state.params.values()))
        with torch.no_grad():
            torch._foreach_copy_(list(state.ema_params.values()),
                                 list(state.params.values()))
    if on_start is not None:
        on_start(step)
    shard = (dict(process_index=shard_index, process_count=shards)
             if shards > 1 else {})
    it = iter(trainer.loader.train_dataloader(
        cfg.global_batch_size, max_steps, step, cfg.seed, **shard))
    guard = PreemptionGuard(enabled=cfg.handle_preemption,
                            sync_every=cfg.preemption_sync_every)
    trainer.preempted = False
    t0 = time.time()
    try:
        if not check_first:
            run_batch(state, batch_to_device(next(it), trainer.device))
            step += 1
        for batch_np in it:
            metrics = run_batch(state, batch_to_device(batch_np,
                                                       trainer.device))
            step += 1
            if step % cfg.log_every == 0:
                m = log_metrics(metrics)
                m['steps_per_sec'] = cfg.log_every / max(
                    time.time() - t0, 1e-9)
                t0 = time.time()
                logger.info('step %d: %s', step, json.dumps(m))
                if metric_hook:
                    metric_hook(step, m)
            preempted = guard.should_stop(step)
            if (step % cfg.checkpointing_steps == 0 or step >= max_steps
                    or preempted):
                sd = (state.state_dict() if layout is None
                      else layout.full_state_dict(state))
                if rank == 0:
                    trainer.ckpt.save(step, sd)
                del sd
                sync_global_devices('checkpoint')
            if preempted:
                trainer.ckpt.wait()
                trainer.preempted = True
                logger.warning('preemption checkpoint written at step %d; '
                               'exiting the train loop', step)
                break
            if step >= max_steps:
                break
    finally:
        guard.restore()
        if hasattr(it, 'close'):  # stop the loader's producer thread
            it.close()
    trainer.ckpt.wait()  # an async save is whole when train() returns
    sync_global_devices('checkpoint written')
    return state
