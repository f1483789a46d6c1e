"""Hand-written Hopper (sm_90a) CUDA kernels of the sampling and training
paths, each with its plain PyTorch version beside it; K1-K5 also run inside
autograd Functions whose backward passes are PyTorch code (``_grad.py``).
The CUDA library is built on first use (``_build.py``); importing this
package builds nothing."""

from fitv2_tpu_torch.kernels.attention import masked_attention
from fitv2_tpu_torch.kernels.flash_attention import (
    attention_bounded_reference, attention_reference, flash_masked_attention)
from fitv2_tpu_torch.kernels.fused_adaln import (
    adaln_norm, adaln_norm_reference, fused_adaln_norm)
from fitv2_tpu_torch.kernels.fused_attention import (
    fused_qkln_rope_attention, fused_qkln_rope_attention_reference,
    qkln_rope_attention)
from fitv2_tpu_torch.kernels.fused_qk_rope import (
    fused_qk_rope, qk_norm_rope, qk_norm_rope_reference)
from fitv2_tpu_torch.kernels.int8_gemm import (
    dequant_gemm, int8_gemm_bias, int8_gemm_bias_reference,
    int8_gemm_swiglu_quant, int8_gemm_swiglu_quant_reference,
    swiglu_requant_gemm)

# every kernel wrapper, each counting its own launches in ``.launches``
KERNEL_WRAPPERS = (fused_adaln_norm, fused_qk_rope, flash_masked_attention,
                   fused_qkln_rope_attention, int8_gemm_bias,
                   int8_gemm_swiglu_quant)

__all__ = [
    'KERNEL_WRAPPERS', 'adaln_norm', 'adaln_norm_reference',
    'attention_bounded_reference', 'attention_reference', 'dequant_gemm',
    'flash_masked_attention', 'fused_adaln_norm', 'fused_qk_rope',
    'fused_qkln_rope_attention', 'fused_qkln_rope_attention_reference',
    'int8_gemm_bias', 'int8_gemm_bias_reference', 'int8_gemm_swiglu_quant',
    'int8_gemm_swiglu_quant_reference', 'masked_attention', 'qk_norm_rope',
    'qk_norm_rope_reference', 'qkln_rope_attention', 'swiglu_requant_gemm',
]
