"""FiT training: the flow (FiTv2) and improved-diffusion (FiTv1) train
steps, the LwD / BFM segment-flow steps, the GAN generator and
discriminator steps, optimizers (AdamW, CAME, grouped and finetune),
schedules, the inline eval hook and the config-driven
trainers (counterpart of fitv2_tpu/train, one device)."""

from fitv2_tpu_torch.train.came import CAME
from fitv2_tpu_torch.train.ddpm_train_step import (
    ddpm_loss, make_ddpm_train_step)
from fitv2_tpu_torch.train.gan_train_step import (
    DiscState, create_disc_state, disc_adam, make_gan_steps)
from fitv2_tpu_torch.train.lr_scheduler import get_scheduler
from fitv2_tpu_torch.train.lwd_train_step import (
    SegmentSampler, make_lwd_distill_step, make_lwd_finetune_step,
    make_lwd_multiscale_train_step, make_lwd_train_step)
from fitv2_tpu_torch.train.train_step import (
    AdamW, GradAccumulator, MultiTransform, OptimizerConfig, TrainState,
    build_optimizer, clip_by_global_norm, create_train_state, flow_loss,
    global_norm, make_finetune_optimizer, make_grouped_optimizer, make_step,
    make_train_step, scale_lr_by_global_batch, update_ema)

__all__ = ['AdamW', 'CAME', 'DiscState', 'GradAccumulator', 'MultiTransform',
           'OptimizerConfig', 'SegmentSampler', 'TrainState',
           'build_optimizer', 'clip_by_global_norm', 'create_disc_state',
           'create_train_state', 'disc_adam',
           'ddpm_loss', 'flow_loss', 'get_scheduler', 'global_norm',
           'make_ddpm_train_step', 'make_finetune_optimizer',
           'make_gan_steps', 'make_grouped_optimizer',
           'make_lwd_distill_step',
           'make_lwd_finetune_step', 'make_lwd_multiscale_train_step',
           'make_lwd_train_step', 'make_step', 'make_train_step',
           'scale_lr_by_global_batch', 'update_ema']
