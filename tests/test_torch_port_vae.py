"""PyTorch port (fitv2_tpu_torch.vae): the SD-VAE decoder against the JAX
package's flax decoder on the same weights, the diffusers-key loader, and
the uint8 conversion.

Tiny decoder (block_out_channels (8, 16)); inputs from numpy with a seed.
Tolerance 2e-4 (fp32 convolutions summed in different orders over up to
16*9 taps, the same bound the JAX package's own torch parity test uses).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fitv2_tpu.vae import AutoencoderKL as JAutoencoderKL
from fitv2_tpu_torch.vae import (
    AutoencoderKL, convert_diffusers_state_dict, images_to_uint8,
    load_vae_state_dict, state_dict_from_flax)
from fitv2_tpu_torch.vae.autoencoder_kl import GroupNorm32

CH = (8, 16)
TOL = 2e-4


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jax_vae(seed=0):
    model = JAutoencoderKL(block_out_channels=CH, latent_channels=4)
    # decode-only init: the decoder and post_quant_conv (the encoder is
    # not ported)
    params = jax.jit(model.init, static_argnames='method')(
        jax.random.PRNGKey(seed), jnp.zeros((1, 4, 6, 4)),
        method='decode')['params']
    # randomize the norms too (flax inits them to 1/0)
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda v: v + 0.05 * rng.standard_normal(v.shape).astype(v.dtype),
        params)
    return model, params


def test_decoder_matches_jax():
    model, params = _jax_vae()
    z = np.random.default_rng(1).standard_normal((2, 4, 6, 4)).astype(
        np.float32)
    want = np.asarray(jax.jit(model.apply, static_argnames='method')(
        {'params': params}, jnp.asarray(z), method='decode'))
    vae = AutoencoderKL(CH)
    vae.load_state_dict(state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, params)), strict=True)
    with torch.no_grad():
        got = vae.decode(torch.from_numpy(z)).numpy()
    assert got.shape == want.shape == (2, 8, 12, 3)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_bf16_decoder_keeps_groupnorm_in_fp32():
    model, params = _jax_vae(2)
    vae = AutoencoderKL(CH)
    vae.load_state_dict(state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    z = torch.randn(1, 4, 4, 4)
    with torch.no_grad():
        ref = vae.decode(z)
        out = vae.to(torch.bfloat16).decode(z)
    assert out.dtype == torch.bfloat16
    # bf16 convolutions: ~2^-8 relative per layer over 9 conv layers
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), atol=0.1,
                               rtol=0.05)


def _diffusers_sd(vae: AutoencoderKL, legacy: bool):
    """A diffusers-layout checkpoint for ``vae``: encoder keys present (they
    are skipped), optionally legacy attention names stored as 1x1 convs."""
    sd = {k: v.clone() for k, v in vae.state_dict().items()}
    sd['encoder.conv_in.weight'] = torch.zeros(8, 3, 3, 3)
    sd['quant_conv.weight'] = torch.zeros(8, 8, 1, 1)
    if legacy:
        for new, old in (('to_q', 'query'), ('to_k', 'key'),
                         ('to_v', 'value'), ('to_out.0', 'proj_attn')):
            for p in ('weight', 'bias'):
                v = sd.pop(f'decoder.mid_block.attentions.0.{new}.{p}')
                sd[f'decoder.mid_block.attentions.0.{old}.{p}'] = (
                    v[:, :, None, None] if p == 'weight' else v)
    return sd


@pytest.mark.parametrize('legacy', [False, True])
def test_diffusers_checkpoint_loads(tmp_path, legacy):
    from safetensors.torch import save_file
    torch.manual_seed(0)
    src = AutoencoderKL(CH)
    path = str(tmp_path / 'vae.safetensors')
    save_file(_diffusers_sd(src, legacy), path)
    dst = AutoencoderKL(CH)
    dst.load_state_dict(load_vae_state_dict(path), strict=True)
    for k, v in src.state_dict().items():
        assert torch.equal(dst.state_dict()[k], v), k
    assert convert_diffusers_state_dict(_diffusers_sd(src, legacy)).keys() \
        == src.state_dict().keys()


def test_uint8_conversion_matches_pipeline_rule():
    """clip to [-1, 1], then clip(127.5 x + 128, 0, 255), truncating cast
    (fitv2_tpu/sample/pipeline.py _decode)."""
    x = np.concatenate([
        np.array([-1.5, -1.0, -0.999, 0.0, 0.5, 0.996, 1.0, 1.5],
                 np.float32),
        np.random.default_rng(0).uniform(-1.2, 1.2, 1000).astype(np.float32)])
    want = np.clip(127.5 * np.clip(x, -1.0, 1.0) + 128.0, 0, 255).astype(
        np.uint8)
    got = images_to_uint8(torch.from_numpy(x)).numpy()
    assert got.dtype == np.uint8
    assert np.array_equal(got, want)
    assert list(got[:8]) == [0, 0, 0, 128, 191, 254, 255, 255]


def test_groupnorm_uses_c_groups_below_32_channels():
    assert GroupNorm32(16).num_groups == 16
    assert GroupNorm32(64).num_groups == 32
