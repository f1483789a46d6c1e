"""Hand-written Hopper (sm_90a) CUDA kernels of the sampling path, each with
its plain PyTorch version beside it. The CUDA library is built on first use
(``_build.py``); importing this package builds nothing."""

from fitv2_tpu_torch.kernels.attention import masked_attention
from fitv2_tpu_torch.kernels.flash_attention import (
    attention_bounded_reference, attention_reference, flash_masked_attention)
from fitv2_tpu_torch.kernels.fused_adaln import (
    adaln_norm, adaln_norm_reference, fused_adaln_norm)
from fitv2_tpu_torch.kernels.fused_qk_rope import (
    fused_qk_rope, qk_norm_rope, qk_norm_rope_reference)

# every kernel wrapper, each counting its own launches in ``.launches``
KERNEL_WRAPPERS = (fused_adaln_norm, fused_qk_rope, flash_masked_attention)

__all__ = [
    'KERNEL_WRAPPERS', 'adaln_norm', 'adaln_norm_reference',
    'attention_bounded_reference', 'attention_reference',
    'flash_masked_attention', 'fused_adaln_norm', 'fused_qk_rope',
    'masked_attention', 'qk_norm_rope', 'qk_norm_rope_reference',
]
