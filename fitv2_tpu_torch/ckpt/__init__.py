from fitv2_tpu_torch.ckpt.convert import state_dict_from_jax
from fitv2_tpu_torch.ckpt.torch_import import (
    convert_fit_state_dict, load_fit_checkpoint, load_torch_state_dict)

__all__ = ['convert_fit_state_dict', 'load_fit_checkpoint',
           'load_torch_state_dict', 'state_dict_from_jax']
