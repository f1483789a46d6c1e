"""FiTv2 flow-matching training: train step, optimizer, schedules and the
config-driven trainer (counterpart of fitv2_tpu/train, one device)."""

from fitv2_tpu_torch.train.lr_scheduler import get_scheduler
from fitv2_tpu_torch.train.train_step import (
    AdamW, GradAccumulator, OptimizerConfig, TrainState, clip_by_global_norm,
    create_train_state, flow_loss, global_norm, make_train_step,
    scale_lr_by_global_batch, update_ema)

__all__ = ['AdamW', 'GradAccumulator', 'OptimizerConfig', 'TrainState',
           'clip_by_global_norm', 'create_train_state', 'flow_loss',
           'get_scheduler', 'global_norm', 'make_train_step',
           'scale_lr_by_global_batch', 'update_ema']
