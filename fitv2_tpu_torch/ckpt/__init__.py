from fitv2_tpu_torch.ckpt.convert import (
    inception_state_from_jax, quant_state_from_jax, state_dict_from_jax)
from fitv2_tpu_torch.ckpt.torch_import import (
    convert_fit_state_dict, load_fit_checkpoint, load_torch_state_dict)

__all__ = ['convert_fit_state_dict', 'inception_state_from_jax',
           'load_fit_checkpoint', 'load_torch_state_dict',
           'quant_state_from_jax', 'state_dict_from_jax']
