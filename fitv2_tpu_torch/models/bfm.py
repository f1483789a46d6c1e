"""BFM (block flow matching): the shared-encoder LwD model at the BFM
defaults.

Counterpart of fitv2_tpu/models/bfm.py: ``BFM(**overrides)`` is a
``FiTLwDSharedEncSepDec`` at config_bfm.yaml's settings (hidden 384, depth
24, 6 heads, K 6, 6 encoder blocks, adaLN-LoRA 96, REPA dim 768), which
``overrides`` replace (configs/bfm_xl.yaml: hidden 1152, depth 30, 20
encoder blocks, RMSNorm q/k, 'normal' adaLN). ``split_decay_param_labels``
is the BFM trainer's parameter grouping.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

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


def split_decay_param_labels(model, no_decay_keywords: Tuple[str, ...] = (
        'bias', 'norm', 'embedding_table')) -> Dict[str, str]:
    """'decay' / 'no_decay' by parameter name, the BFM trainer's grouping
    (``train_step.make_grouped_optimizer``): each parameter gets the label
    that JAX gives its leaf (``ckpt.jax_leaves``): 'no_decay' where the
    leaf's lower-cased flax path holds a keyword or the leaf's rank is at
    most 1 (a depth-stacked bias is rank 2 there)."""
    from fitv2_tpu_torch.ckpt.convert import jax_leaves
    labels = {}
    for leaf in jax_leaves(model):
        no_decay = (any(kw in leaf.path.lower() for kw in no_decay_keywords)
                    or leaf.ndim <= 1)
        labels.update((n, 'no_decay' if no_decay else 'decay')
                      for n in leaf.names)
    return labels
