from fitv2_tpu_torch.vae.autoencoder_kl import (
    SD_VAE_SCALE, AutoencoderKL, images_to_uint8, sample_latent)
from fitv2_tpu_torch.vae.torch_import import (
    convert_diffusers_state_dict, load_vae_state_dict, state_dict_from_flax)

__all__ = ['SD_VAE_SCALE', 'AutoencoderKL', 'convert_diffusers_state_dict',
           'images_to_uint8', 'load_vae_state_dict', 'sample_latent',
           'state_dict_from_flax']
