from fitv2_tpu_torch.models.fit import FiT, forward_with_cfg

__all__ = ['FiT', 'forward_with_cfg']
