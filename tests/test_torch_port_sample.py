"""PyTorch port (fitv2_tpu_torch.sample / flow / cli / utils): the CFG Euler
sampler and its speed modes (guidance interval, velocity extrapolation of
order 1 and 2, both composed) against the JAX package's ``build_sampler``
on the same weights and the same noise, the FID loop's resume semantics,
the config loader and the sampling CLI.

The noise is exactly what the JAX sampler draws,
``jax.random.normal(rng, (B, n_ctx, 16))``, handed to the port as ``z``.
Tolerance: fp32 over 4 Euler steps of a 2-block FiT, 5e-5 abs/rel (per-step
forward agreement is ~2e-5; the steps add up); 1e-4 over the 8 steps of
the speed modes, whose extrapolation adds the velocity differences of
three evaluations.
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
    vparams = jax.jit(jvae.init)(jax.random.PRNGKey(1),
                                 jnp.zeros((1, 16, 16, 3)))['params']
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


SPEED_MODES = {
    'interval': dict(guidance_low=0.3, guidance_high=0.7),
    'extrap_order1': dict(velocity_eval_every=2),
    'extrap_order2_tail': dict(velocity_eval_every=3,
                               velocity_extrap_order=2),
    'composed': dict(guidance_low=0.3, guidance_high=0.7,
                     velocity_eval_every=2, velocity_extrap_order=2),
}


@pytest.mark.parametrize('mode', list(SPEED_MODES))
def test_speed_mode_sampler_matches_jax(models, mode):
    """8 steps on the padded 3x4 bucket: the interval's pre/window/post
    phases are steps 0-2 / 3-5 / 6-7, extrapolation with a tail block of 2
    for eval_every=3."""
    jm, params, pm, _ = models
    kw = dict(image_height=48, image_width=64, num_sampling_steps=8,
              cfg_scale=1.5, num_classes=10, per_device_batch=B,
              **SPEED_MODES[mode])
    jfn = j_build_sampler(jm, params, JSamplingConfig(dtype=jnp.float32,
                                                       **kw))
    rng = jax.random.PRNGKey(11)
    labels = np.array([2, 7])
    want = np.asarray(jfn(rng, jnp.asarray(labels)))
    z = np.array(jax.random.normal(rng, (B, 16, 16), jnp.float32))
    scfg = SamplingConfig(dtype=torch.float32, **kw)
    got = build_sampler(pm, scfg)(torch.from_numpy(labels),
                                  z=torch.from_numpy(z)).numpy()
    assert got.shape == want.shape == (B, 4, 6, 8)
    # the mode changed the result: not the dense path under another name
    dense = build_sampler(pm, SamplingConfig(
        dtype=torch.float32, **{k: v for k, v in kw.items()
                                if k not in SPEED_MODES[mode]}))
    ref = dense(torch.from_numpy(labels), z=torch.from_numpy(z)).numpy()
    assert np.abs(got - ref).max() > 1e-3
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_euler_ladder_equals_jax_linspace_bit_for_bit():
    """The port's time ladder against the one JAX's sampler builds
    (``jnp.linspace(0.0, 1.0, n + 1)``, fitv2_tpu/sample/pipeline.py) at
    every step count up to 300 and at 500 and 1000 (``torch.linspace``
    differs at 286 of them)."""
    from fitv2_tpu_torch.flow import euler_ladder
    for n in [*range(1, 301), 500, 1000]:
        got = euler_ladder(n)
        want = np.asarray(jnp.linspace(0.0, 1.0, n + 1))
        assert got.dtype == want.dtype == np.float32
        assert np.array_equal(got, want), n


@pytest.mark.parametrize('mode', ['dense', 'interval'])
def test_sampler_matches_jax_where_the_ladders_used_to_differ(models, mode):
    """6 steps, where torch.linspace's ladder is 1 ulp off JAX's at 2
    entries: the sampled latents agree within 2e-6 (the 2-block forward's
    own fp32 differences are ~5e-7 here)."""
    jm, params, pm, _ = models
    extra = dict(guidance_low=0.3, guidance_high=0.7) if mode == 'interval' \
        else {}
    kw = dict(image_height=48, image_width=64, num_sampling_steps=6,
              cfg_scale=1.5, num_classes=10, per_device_batch=B, **extra)
    jfn = j_build_sampler(jm, params, JSamplingConfig(dtype=jnp.float32,
                                                       **kw))
    rng = jax.random.PRNGKey(5)
    labels = np.array([4, 8])
    want = np.asarray(jfn(rng, jnp.asarray(labels)))
    z = np.array(jax.random.normal(rng, (B, 16, 16), jnp.float32))
    got = build_sampler(pm, SamplingConfig(dtype=torch.float32, **kw))(
        torch.from_numpy(labels), z=torch.from_numpy(z)).numpy()
    assert np.abs(want).max() > 1.0
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)


def test_guidance_phases_split_the_ladder():
    from fitv2_tpu_torch.sample.pipeline import guidance_phases
    cfg = SamplingConfig(num_sampling_steps=8, guidance_low=0.3,
                         guidance_high=0.7)
    assert guidance_phases(cfg) == (3, 6)
    assert guidance_phases(SamplingConfig(num_sampling_steps=10,
                                          guidance_low=0.3,
                                          guidance_high=0.9)) == (3, 10)
    # inclusive bounds on the float64 ladder (t = 0.25 is in [0.25, 0.5])
    assert guidance_phases(SamplingConfig(num_sampling_steps=4,
                                          guidance_low=0.25,
                                          guidance_high=0.5)) == (1, 3)
    assert guidance_phases(SamplingConfig(num_sampling_steps=4,
                                          guidance_low=0.9,
                                          guidance_high=0.1)) == (0, 0)


def test_extrapolation_matches_jax_on_a_curved_field():
    """The samplers alone on an analytic field (no model): same ladder,
    same state, order 1 and 2 and a non-dividing ladder."""
    from fitv2_tpu.flow.samplers import (
        euler_sample_extrapolated as j_extrap)
    from fitv2_tpu_torch.flow import euler_sample_extrapolated

    def field_j(x, t):
        return jnp.sin(3.0 * t)[:, None] * x + jnp.cos(5.0 * t)[:, None]

    def field_p(x, t):
        return torch.sin(3.0 * t)[:, None] * x + torch.cos(5.0 * t)[:, None]

    x = np.random.default_rng(0).standard_normal((3, 5)).astype(np.float32)
    sig = jnp.linspace(0.0, 1.0, 11)
    for every, order in ((2, 1), (3, 2), (4, 2)):
        want = np.asarray(j_extrap(field_j, jnp.asarray(x), sig,
                                   eval_every=every, order=order))
        got = euler_sample_extrapolated(field_p, torch.from_numpy(x),
                                        np.asarray(sig), every, order)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match='order'):
        euler_sample_extrapolated(field_p, torch.from_numpy(x),
                                  np.asarray(sig), 2, 3)


def test_sampler_refuses_bad_speed_settings(models):
    pm = models[2]
    for kw in (dict(velocity_extrap_order=3), dict(velocity_eval_every=0)):
        with pytest.raises(ValueError, match='velocity'):
            build_sampler(pm, SamplingConfig(num_classes=10, **kw))


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
        config_to_model({'target': 'fitv2_tpu.encoders.dinov2.DinoV2ViT'})


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
    (['--data-parallel'], 'slice 9'),
    (['--global-seed', '3', '--data-parallel'], 'slice 9'),
])
def test_cli_refuses_flags_of_later_slices(models, tmp_path, flags,
                                          slice_name):
    """No flag of the CLI is refused any more: ``--data-parallel`` (slice
    9a) in one process is the path without it, bit for bit (its runs
    across processes: tests/test_torch_port_parallel.py)."""
    cfg_path, ckpt = _write_cli_inputs(tmp_path, models[3])
    common = ['--cfgdir', cfg_path, '--ckpt', ckpt, '--image-height', '64',
              '--image-width', '48', '--num-sampling-steps', '3',
              '--num-fid-samples', '3', '--per-device-batch', '2',
              '--num-classes', '10', '--device', 'cpu']
    outs = []
    for extra in (flags, [f for f in flags if f != '--data-parallel']):
        outs.append(str(tmp_path / f'{len(extra)}.npz'))
        cli.main(common + extra + ['--out', outs[-1]])
    a, b = (np.load(o)['arr_0'] for o in outs)
    assert a.shape == (3, 4, 8, 6) and np.array_equal(a, b), slice_name


def test_cli_interpolation_to_npz_on_cpu(models, tmp_path):
    """--interpolation dynntk --decouple --ori-max-pe-len on a padded 4 x 3
    bucket of a model trained at 2 x 2, against the same run through the
    library and against JAX's sampler on the same noise."""
    jm, params, pm, pnp = models
    cfg_path, ckpt = _write_cli_inputs(tmp_path, pnp)
    out = str(tmp_path / 'dynntk.npz')
    cli.main(['--cfgdir', cfg_path, '--ckpt', ckpt, '--image-height', '64',
              '--image-width', '48', '--num-sampling-steps', '3',
              '--num-fid-samples', '2', '--per-device-batch', '2',
              '--num-classes', '10', '--interpolation', 'dynntk',
              '--decouple', '--ori-max-pe-len', '2', '--device', 'cpu',
              '--out', out])
    arr = np.load(out)['arr_0']
    assert arr.shape == (2, 4, 8, 6) and np.isfinite(arr).all()
    kw = dict(image_height=64, image_width=48, num_sampling_steps=3,
              num_classes=10, per_device_batch=2, interpolation='dynntk',
              decouple=True, ori_max_pe_len=2)
    fn = build_sampler(pm, SamplingConfig(**kw))
    np.testing.assert_allclose(
        arr, generate_fid_samples(fn, 2, 2, num_classes=10, seed=0),
        rtol=1e-6, atol=1e-6)
    rng = jax.random.PRNGKey(1)
    labels = np.array([5, 0])
    want = np.asarray(j_build_sampler(jm, params, JSamplingConfig(
        dtype=jnp.float32, **kw))(rng, jnp.asarray(labels)))
    z = np.array(jax.random.normal(rng, (B, 16, 16), jnp.float32))
    got = build_sampler(pm, SamplingConfig(dtype=torch.float32, **kw))(
        torch.from_numpy(labels), z=torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_cli_int8_serving_max_to_npz_on_cpu(models, tmp_path):
    """int8 + guidance interval + quadratic velocity extrapolation through
    the CLI, against the same run through the library."""
    _, _, pm, pnp = models
    cfg_path, ckpt = _write_cli_inputs(tmp_path, pnp)
    out = str(tmp_path / 'serving_max.npz')
    cli.main(['--cfgdir', cfg_path, '--ckpt', ckpt, '--image-height', '64',
              '--image-width', '48', '--num-sampling-steps', '6',
              '--num-fid-samples', '3', '--per-device-batch', '2',
              '--num-classes', '10', '--global-seed', '2',
              '--gemm-precision', 'int8', '--guidance-low', '0.3',
              '--guidance-high', '0.9', '--velocity-eval-every', '2',
              '--velocity-extrap-order', '2', '--device', 'cpu',
              '--out', out])
    arr = np.load(out)['arr_0']
    assert arr.shape == (3, 4, 8, 6) and np.isfinite(arr).all()
    model = FiT(**dict(SMALL, gemm_precision='int8'))
    model.load_state_dict(pm.state_dict())
    fn = build_sampler(model.eval(), SamplingConfig(
        image_height=64, image_width=48, num_sampling_steps=6,
        num_classes=10, per_device_batch=2, guidance_low=0.3,
        guidance_high=0.9, velocity_eval_every=2, velocity_extrap_order=2))
    assert model.blocks[0].mlp.fc1.weight_q is not None
    np.testing.assert_allclose(
        arr, generate_fid_samples(fn, 3, 2, num_classes=10, seed=2),
        rtol=1e-6, atol=1e-6)


def test_config_passes_attn_impl_and_gemm_precision_through():
    net = {'target': 'fitv2_tpu.models.fit.FiT',
           'params': dict(SMALL, attn_impl='fused', gemm_precision='int8')}
    model = config_to_model(net)
    assert model.gemm_precision == 'int8'
    assert all(b.attn.fused for b in model.blocks)
    assert type(model.blocks[0].mlp.fc2).__name__ == 'Int8Linear'


def test_cli_cuda_device_without_cuda_raises(models, tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    cfg_path, ckpt = _write_cli_inputs(tmp_path, models[3])
    with pytest.raises(RuntimeError, match='no CUDA device'):
        cli.main(['--cfgdir', cfg_path, '--ckpt', ckpt])
