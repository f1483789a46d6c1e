"""Perceptual and GAN losses (counterpart of fitv2_tpu/losses)."""

from fitv2_tpu_torch.losses.perceptual import (
    LPIPS, LPIPSWithDiscriminator2D, LPIPSWithDiscriminator3D,
    NLayerDiscriminator, NLayerDiscriminator3D, adopt_weight,
    calculate_adaptive_weight, convert_lpips_state_dict, hinge_d_loss,
    vanilla_d_loss)

__all__ = [
    'LPIPS', 'LPIPSWithDiscriminator2D', 'LPIPSWithDiscriminator3D',
    'NLayerDiscriminator', 'NLayerDiscriminator3D', 'adopt_weight',
    'calculate_adaptive_weight', 'convert_lpips_state_dict',
    'hinge_d_loss', 'vanilla_d_loss',
]
