"""PyTorch port (fitv2_tpu_torch.sample / cli / utils): the CFG Euler
sampler against the JAX package's ``build_sampler`` on the same weights and
the same noise, the FID loop's resume semantics, the config loader and the
sampling CLI.

The noise is exactly what the JAX sampler draws,
``jax.random.normal(rng, (B, n_ctx, 16))``, handed to the port as ``z``.
Tolerance: fp32 over 4 Euler steps of a 2-block FiT, 5e-5 abs/rel (per-step
forward agreement is ~2e-5; the steps add up).
"""

import os

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from fitv2_tpu.ckpt.torch_export import export_fit_state_dict, save_safetensors
from fitv2_tpu.models.fit import FiT as JFiT
from fitv2_tpu.models.grid_utils import make_grid_mask_size as j_grid
from fitv2_tpu.sample import SamplingConfig as JSamplingConfig
from fitv2_tpu.sample import build_sampler as j_build_sampler

from fitv2_tpu_torch.ckpt import state_dict_from_jax
from fitv2_tpu_torch.cli import sample as cli
from fitv2_tpu_torch.models import FiT
from fitv2_tpu_torch.sample import (
    SamplingConfig, build_sampler, generate_fid_samples, save_npz)
from fitv2_tpu_torch.utils import config_to_model, load_config

TOL = 5e-5
B = 2
SMALL = dict(context_size=16, patch_size=2, in_channels=4, hidden_size=144,
             depth=2, num_heads=2, learn_sigma=False, use_sit=True,
             use_swiglu=True, q_norm='layernorm', k_norm='layernorm',
             adaln_type='lora', adaln_lora_dim=36, num_classes=10,
             max_cached_len=16)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope='module')
def models():
    """JAX FiT + params (zero-init leaves perturbed, so the velocity is not
    identically 0) and the port FiT with the same weights."""
    jm = JFiT(**SMALL)
    g, _, s = j_grid(1, 4, 4, 16)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16)),
                     jnp.zeros((1,)), jnp.zeros((1,), jnp.int32), g, None,
                     s)['params']
    rng = np.random.default_rng(0)

    def perturb(path, v):
        p = jax.tree_util.keystr(path)
        if 'fc_out' in p or 'final_layer' in p:
            return v + 0.05 * rng.standard_normal(v.shape).astype(v.dtype)
        return v
    params = jax.tree_util.tree_map_with_path(perturb, params)
    pnp = jax.tree_util.tree_map(np.asarray, params)
    pm = FiT(**SMALL)
    pm.load_state_dict(state_dict_from_jax(pnp, depth=2, num_heads=2,
                                           adaln_type='lora'))
    return jm, params, pm.eval(), pnp


@pytest.mark.parametrize('pixels', [(64, 64), (48, 64)],
                         ids=['full_4x4', 'padded_3x4'])
def test_sampler_matches_jax(models, pixels):
    jm, params, pm, _ = models
    h, w = pixels
    jfn = j_build_sampler(jm, params, JSamplingConfig(
        image_height=h, image_width=w, num_sampling_steps=4, cfg_scale=1.5,
        num_classes=10, per_device_batch=B, dtype=jnp.float32))
    rng = jax.random.PRNGKey(7)
    labels = np.array([3, 9])
    want = np.asarray(jfn(rng, jnp.asarray(labels)))
    z = np.array(jax.random.normal(rng, (B, 16, 16), jnp.float32))
    pfn = build_sampler(pm, SamplingConfig(
        image_height=h, image_width=w, num_sampling_steps=4, cfg_scale=1.5,
        num_classes=10, per_device_batch=B, dtype=torch.float32))
    got = pfn(torch.from_numpy(labels), z=torch.from_numpy(z)).numpy()
    assert got.shape == want.shape == (B, 4, h // 8, w // 8)
    # the sampler moved the latents: the comparison is not vacuous
    z_img = pm.unpatchify(torch.from_numpy(z)[:, :(h // 16) * (w // 16)],
                          (h // 8, w // 8)).numpy()
    assert np.abs(want - z_img).max() > 0.05
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_sampler_with_vae_matches_jax(models):
    from fitv2_tpu.vae import AutoencoderKL as JAutoencoderKL
    from fitv2_tpu_torch.vae import AutoencoderKL, state_dict_from_flax
    jm, params, pm, _ = models
    jvae = JAutoencoderKL(block_out_channels=(8, 16))
    vparams = jax.jit(jvae.init, static_argnames='method')(
        jax.random.PRNGKey(1), jnp.zeros((1, 8, 8, 4)),
        method='decode')['params']
    jfn = j_build_sampler(jm, params, JSamplingConfig(
        image_height=64, image_width=64, num_sampling_steps=2,
        num_classes=10, per_device_batch=B, dtype=jnp.float32), jvae, vparams)
    rng = jax.random.PRNGKey(3)
    labels = np.array([1, 10])  # the null class is a legal label too
    want = np.asarray(jfn(rng, jnp.asarray(labels)))
    vae = AutoencoderKL((8, 16))
    vae.load_state_dict(state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, vparams)))
    pfn = build_sampler(pm, SamplingConfig(
        image_height=64, image_width=64, num_sampling_steps=2,
        num_classes=10, per_device_batch=B, dtype=torch.float32), vae.eval())
    z = np.array(jax.random.normal(rng, (B, 16, 16), jnp.float32))
    got = pfn(torch.from_numpy(labels), z=torch.from_numpy(z)).numpy()
    assert got.dtype == want.dtype == np.uint8
    assert got.shape == want.shape == (B, 16, 16, 3)
    # fp32 decode differences can move a pixel across a rounding boundary
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff == 0).mean() > 0.99


def test_fid_loop_resumes_bit_identically(models, tmp_path):
    _, _, pm, _ = models
    cfg = SamplingConfig(image_height=64, image_width=64,
                         num_sampling_steps=2, num_classes=10,
                         per_device_batch=B, dtype=torch.float32)
    fn = build_sampler(pm, cfg)
    ref = generate_fid_samples(fn, 5, B, num_classes=10, seed=4)
    assert ref.shape == (5, 4, 8, 8)
    rd = str(tmp_path / 'shards')
    first = generate_fid_samples(fn, 5, B, num_classes=10, seed=4,
                                 resume_dir=rd)
    os.remove(os.path.join(rd, 'shard_b1.npy'))  # preempted mid-run
    resumed = generate_fid_samples(fn, 5, B, num_classes=10, seed=4,
                                   resume_dir=rd)
    assert np.array_equal(first, ref) and np.array_equal(resumed, ref)
    other = build_sampler(pm, SamplingConfig(
        image_height=64, image_width=64, num_sampling_steps=3,
        num_classes=10, per_device_batch=B, dtype=torch.float32))
    with pytest.raises(ValueError, match='manifest mismatch'):
        generate_fid_samples(other, 5, B, num_classes=10, seed=4,
                             resume_dir=rd)
    save_npz(str(tmp_path / 's.npz'), ref, 3)
    assert np.load(str(tmp_path / 's.npz'))['arr_0'].shape == (3, 4, 8, 8)


def test_config_to_model_builds_the_xl_config():
    cfg = load_config(os.path.join(REPO, 'configs', 'fitv2_xl.yaml'))
    net = cfg['diffusion']['network_config']
    model = config_to_model(net, depth=1)  # full width, cut depth
    assert (model.hidden_size, model.num_heads, model.head_dim) == \
        (1152, 16, 72)
    assert model.out_channels == 4 and model.adaln_type == 'lora'
    assert model.blocks[0].adaLN_modulation.fc1.out_features == 288
    assert model.blocks[0].mlp.fc1.out_features == 2 * 3072
    assert model.blocks[0].attn.bounded and model.blocks[0].attn.fuse_qk
    assert model.y_embedder.embedding_table.shape == (1001, 1152)
    assert cfg['accelerate']['optimizer']['params']['betas'] == (0.9, 0.999)
    with pytest.raises(NotImplementedError, match='not ported'):
        config_to_model({'target': 'fitv2_tpu.models.fit_lwd.FiTLwD'})


def _write_cli_inputs(tmp_path, pnp):
    cfg = {'diffusion': {'network_config': {
        'target': 'fitv2_tpu.models.fit.FiT', 'params': SMALL}}}
    cfg_path = str(tmp_path / 'tiny.yaml')
    with open(cfg_path, 'w') as f:
        yaml.safe_dump(cfg, f)
    ckpt = str(tmp_path / 'tiny.safetensors')
    save_safetensors(export_fit_state_dict(pnp, depth=2, adaln_type='lora',
                                           num_heads=2, rope_layout='split'),
                     ckpt)
    return cfg_path, ckpt


def test_cli_samples_to_npz_on_cpu(models, tmp_path):
    _, _, pm, pnp = models
    cfg_path, ckpt = _write_cli_inputs(tmp_path, pnp)
    out = str(tmp_path / 'samples.npz')
    cli.main(['--cfgdir', cfg_path, '--ckpt', ckpt, '--image-height', '64',
              '--image-width', '64', '--num-sampling-steps', '2',
              '--num-fid-samples', '3', '--per-device-batch', '2',
              '--num-classes', '10', '--global-seed', '5', '--device', 'cpu',
              '--out', out])
    arr = np.load(out)['arr_0']
    assert arr.shape == (3, 4, 8, 8) and np.isfinite(arr).all()
    # the same run through the library (the CLI's default dtype is bf16)
    fn = build_sampler(pm, SamplingConfig(
        image_height=64, image_width=64, num_sampling_steps=2,
        num_classes=10, per_device_batch=2))
    np.testing.assert_allclose(
        arr, generate_fid_samples(fn, 3, 2, num_classes=10, seed=5),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize('flags,slice_name', [
    (['--gemm-precision', 'int8'], 'slice 3'),
    (['--guidance-low', '0.3'], 'slice 3'),
    (['--velocity-eval-every', '2'], 'slice 3'),
    (['--interpolation', 'dynntk'], 'slice 4'),
    (['--sampler-mode', 'ddim'], 'slice 6'),
    (['--data-parallel'], 'slice 9'),
])
def test_cli_refuses_flags_of_later_slices(flags, slice_name):
    with pytest.raises(NotImplementedError, match=slice_name):
        cli.main(['--cfgdir', 'unused.yaml', '--ckpt', 'unused', *flags])


def test_cli_cuda_device_without_cuda_raises(models, tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    cfg_path, ckpt = _write_cli_inputs(tmp_path, models[3])
    with pytest.raises(RuntimeError, match='no CUDA device'):
        cli.main(['--cfgdir', cfg_path, '--ckpt', ckpt])
