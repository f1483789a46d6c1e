from fitv2_tpu_torch.models.bfm import BFM
from fitv2_tpu_torch.models.fit import FiT, forward_with_cfg
from fitv2_tpu_torch.models.fit_lwd import FiTLwD, repa_alignment_loss
from fitv2_tpu_torch.models.fit_lwd_sharedenc import FiTLwDSharedEncSepDec

__all__ = ['BFM', 'FiT', 'FiTLwD', 'FiTLwDSharedEncSepDec',
           'forward_with_cfg', 'repa_alignment_loss']
