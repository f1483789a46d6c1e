from fitv2_tpu_torch.utils.config import config_to_model, load_config

__all__ = ['config_to_model', 'load_config']
