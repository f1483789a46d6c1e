from fitv2_tpu_torch.ckpt.checkpoint import (
    CheckpointManager, latest_checkpoint_step, list_checkpoints)
from fitv2_tpu_torch.ckpt.convert import (
    came_state_from_jax, disc_state_from_jax, inception_state_from_jax,
    jax_leaves, lpips_state_from_jax, lwd_quant_state_from_jax,
    lwd_state_from_jax, quant_state_from_jax, state_dict_from_jax,
    teacher_state_from_jax, train_state_from_jax)
from fitv2_tpu_torch.ckpt.torch_import import (
    convert_fit_state_dict, load_fit_checkpoint, load_torch_state_dict)

__all__ = ['CheckpointManager', 'came_state_from_jax', 'convert_fit_state_dict',
           'disc_state_from_jax', 'inception_state_from_jax',
           'latest_checkpoint_step', 'jax_leaves', 'list_checkpoints',
           'load_fit_checkpoint', 'load_torch_state_dict',
           'lpips_state_from_jax', 'lwd_quant_state_from_jax',
           'lwd_state_from_jax', 'quant_state_from_jax',
           'state_dict_from_jax', 'teacher_state_from_jax',
           'train_state_from_jax']
