"""BFM (block flow matching): the shared-encoder LwD model at the BFM
defaults.

Counterpart of fitv2_tpu/models/bfm.py: ``BFM(**overrides)`` is a
``FiTLwDSharedEncSepDec`` at config_bfm.yaml's settings (hidden 384, depth
24, 6 heads, K 6, 6 encoder blocks, adaLN-LoRA 96, REPA dim 768), which
``overrides`` replace (configs/bfm_xl.yaml: hidden 1152, depth 30, 20
encoder blocks, RMSNorm q/k, 'normal' adaLN). The BFM trainer's parameter
grouping (``split_decay_param_labels``) comes with LwD training.
"""

from __future__ import annotations

from typing import Any, Dict

from fitv2_tpu_torch.models.fit_lwd_sharedenc import FiTLwDSharedEncSepDec

BFM_DEFAULTS: Dict[str, Any] = dict(
    context_size=256, patch_size=2, in_channels=4, hidden_size=384,
    depth=24, num_heads=6, num_classes=1000, learn_sigma=False,
    use_sit=True, use_swiglu=True, q_norm='layernorm', k_norm='layernorm',
    adaln_type='lora', adaln_lora_dim=96, number_of_perflow=6,
    number_of_representation_blocks=6, repa_dim=768, n_patch_h=16,
    n_patch_w=16)


def BFM(**overrides) -> FiTLwDSharedEncSepDec:
    """The shared-encoder LwD model at the BFM defaults."""
    return FiTLwDSharedEncSepDec(**{**BFM_DEFAULTS, **overrides})
