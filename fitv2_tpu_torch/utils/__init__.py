from fitv2_tpu_torch.utils.config import (
    config_to_model, get_obj_from_str, instantiate_from_config, load_config)

__all__ = ['config_to_model', 'get_obj_from_str', 'instantiate_from_config',
           'load_config']
