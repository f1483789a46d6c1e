"""PyTorch port, slice 6 (FiTv1): improved diffusion (``sched/``), the
ddpm / ddim branch of ``build_sampler``, the ddpm train step, the trainer's
ddpm objective and the CLIs, against the JAX package on the same numpy
inputs.

``jax.random`` and torch streams never match: every test rebuilds JAX's
draws with ``jax.random`` (the initial noise, the per-step noise of the
ancestral loop, the training noise) and hands them to the port as
tensors.

Tolerances:
- the coefficient ladders, the respacing maps and the flow-match ladders:
  bit for bit;
- ``p_mean_variance``, ``training_losses`` and the 50-step respaced loops
  on an analytic model, fp32: 1e-5 of the largest magnitude (the same
  formulas, transcendental ulps apart);
- the committed golden (an independent float64 implementation): JAX's own
  test's tolerance, rtol 2e-4 and atol 2e-5;
- a small FiTv1 (depth 2, learn_sigma, no q/k norm, perturbed zero-init
  leaves) through ``build_sampler``, 10 steps, CFG 1.5, fp32: 1e-4
  relative L2;
- two ddpm train steps against ``make_ddpm_train_step``: loss 1e-5
  relative; parameters at the flow step's AdamW tolerance (each step at
  most 2 lr apart, at most 1% of elements off by more than 2e-6).
"""

import os
import types

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from fitv2_tpu.ckpt.torch_export import export_fit_state_dict, save_safetensors
from fitv2_tpu.cli import sample as jcli_sample
from fitv2_tpu.data import latent_dataset as jld
from fitv2_tpu.models.fit import FiT as JFiT
from fitv2_tpu.models.grid_utils import make_grid_mask_size as j_grid
from fitv2_tpu.sample import SamplingConfig as JSamplingConfig
from fitv2_tpu.sample import build_sampler as j_build_sampler
from fitv2_tpu.sched import flow_match as jfm
from fitv2_tpu.sched import gaussian_diffusion as jgd
from fitv2_tpu.sched import timestep_sampler as jtsamp
from fitv2_tpu.train import train_step as jts
from fitv2_tpu.train.ddpm_train_step import make_ddpm_train_step as j_make

from fitv2_tpu_torch.ckpt import state_dict_from_jax, train_state_from_jax
from fitv2_tpu_torch.cli import sample as cli_sample
from fitv2_tpu_torch.cli import train as cli_train
from fitv2_tpu_torch.data import make_synthetic_latent_shards
from fitv2_tpu_torch.models import FiT
from fitv2_tpu_torch.sample import (
    SamplingConfig, build_sampler, generate_fid_samples)
from fitv2_tpu_torch.sched import flow_match as tfm
from fitv2_tpu_torch.sched import gaussian_diffusion as tgd
from fitv2_tpu_torch.sched import timestep_sampler as ttsamp
from fitv2_tpu_torch.train import train_step as tts
from fitv2_tpu_torch.train.ddpm_train_step import make_ddpm_train_step
from fitv2_tpu_torch.train.trainer import Trainer, TrainerConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = np.load(os.path.join(REPO, 'tests', 'goldens', 'ddpm.npz'))
TOL = 1e-5
TOL_SAMPLER_REL_L2 = 1e-4
B = 2
# FiTv1 at a small size: configs/fit_xl.yaml's structure (learn_sigma,
# SwiGLU-large, adaLN 'normal', no q/k norm), hidden 64, 4 heads, depth 2
V1 = dict(context_size=16, patch_size=2, in_channels=4, hidden_size=64,
          depth=2, num_heads=4, learn_sigma=True, use_swiglu=True,
          use_swiglu_large=True, adaln_type='normal', num_classes=10,
          max_cached_len=16)
KW = dict(depth=2, num_heads=4, adaln_type='normal')


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(ours, ref, tol=TOL):
    ours = np.asarray(ours.detach() if isinstance(ours, torch.Tensor)
                      else ours, np.float32)
    ref = np.asarray(ref, np.float32)
    assert ours.shape == ref.shape
    scale = max(np.abs(ref).max(), 1e-30)
    assert np.abs(ours - ref).max() <= tol * scale, \
        np.abs(ours - ref).max() / scale


# -- the ladders ----------------------------------------------------------------

# the port's ladder -> how JAX's _ext forms it from its float64 ladders
LADDERS = {
    'alphas_cumprod': lambda c: c['alphas_cumprod'],
    'alphas_cumprod_prev': lambda c: c['alphas_cumprod_prev'],
    'alphas_cumprod_next': lambda c: c['alphas_cumprod_next'],
    'one_minus_alphas_cumprod': lambda c: 1.0 - c['alphas_cumprod'],
    'sqrt_alphas_cumprod': lambda c: c['sqrt_alphas_cumprod'],
    'sqrt_one_minus_alphas_cumprod':
        lambda c: c['sqrt_one_minus_alphas_cumprod'],
    'log_one_minus_alphas_cumprod':
        lambda c: c['log_one_minus_alphas_cumprod'],
    'sqrt_recip_alphas_cumprod': lambda c: c['sqrt_recip_alphas_cumprod'],
    'sqrt_recipm1_alphas_cumprod':
        lambda c: c['sqrt_recipm1_alphas_cumprod'],
    'posterior_variance': lambda c: c['posterior_variance'],
    'posterior_log_variance_clipped':
        lambda c: c['posterior_log_variance_clipped'],
    'posterior_mean_coef1': lambda c: c['posterior_mean_coef1'],
    'posterior_mean_coef2': lambda c: c['posterior_mean_coef2'],
    'recip_posterior_mean_coef1': lambda c: 1.0 / c['posterior_mean_coef1'],
    'posterior_mean_coef2_over_coef1':
        lambda c: c['posterior_mean_coef2'] / c['posterior_mean_coef1'],
    'log_betas': lambda c: np.log(c['betas64']),
    'fixed_large_variance': lambda c: np.append(c['posterior_variance'][1],
                                                c['betas64'][1:]),
    'fixed_large_log_variance': lambda c: np.log(np.append(
        c['posterior_variance'][1], c['betas64'][1:])),
}


@pytest.mark.parametrize('schedule', ['linear', 'squaredcos_cap_v2'])
@pytest.mark.parametrize('respacing', ['', '250', '50', 'ddim25', '10,20,5'])
def test_ladders_and_respacing_are_bit_equal(schedule, respacing):
    jd = jgd.create_diffusion(timestep_respacing=respacing,
                              noise_schedule=schedule)
    td = tgd.create_diffusion(timestep_respacing=respacing,
                              noise_schedule=schedule)
    assert td.num_timesteps == jd.num_timesteps
    np.testing.assert_array_equal(td.betas, jd.betas)
    if jd.timestep_map is None:
        assert td.timestep_map is None
    else:
        np.testing.assert_array_equal(td.timestep_map, jd.timestep_map)
    for name, form in LADDERS.items():
        want = np.asarray(jnp.asarray(form(jd._c), jnp.float32))
        got = td._ladder(name, torch.device('cpu')).numpy()
        np.testing.assert_array_equal(got, want, err_msg=name)
    for steps, spec in ((1000, '250'), (1000, 'ddim50'), (100, '7,3')):
        assert tgd.space_timesteps(steps, spec) == \
            jgd.space_timesteps(steps, spec)
    np.testing.assert_array_equal(
        tgd.get_named_beta_schedule(schedule, 300),
        jgd.get_named_beta_schedule(schedule, 300))


# -- the math on an analytic model -------------------------------------------------

LIN = np.linspace(-1.0, 1.0, 4).astype(np.float32)


def _jmodel(T, two_c=True):
    """The golden's analytic model (tests/test_ddpm_golden.py)."""
    def model_fn(x, t_orig):
        tt = (t_orig.astype(jnp.float32) / T)[:, None, None]
        eps = 0.1 * x * jnp.cos(3.0 * tt) + 0.05 * jnp.sin(5.0 * tt + LIN)
        if not two_c:
            return eps
        return jnp.concatenate([eps, jnp.tanh(0.1 * x + LIN * tt)], -1)
    return model_fn


def _tmodel(T, two_c=True):
    lin = torch.from_numpy(LIN)

    def model_fn(x, t_orig):
        tt = (t_orig.float() / T)[:, None, None]
        eps = 0.1 * x * torch.cos(3.0 * tt) + 0.05 * torch.sin(5.0 * tt + lin)
        if not two_c:
            return eps
        return torch.cat([eps, torch.tanh(0.1 * x + lin * tt)], -1)
    return model_fn


VARIANTS = {
    'learned_range': dict(learn_sigma=True),
    'fixed_large': dict(learn_sigma=False),
    'fixed_small': dict(learn_sigma=False, sigma_small=True),
    'start_x': dict(learn_sigma=True, predict_xstart=True),
    'rescaled_mse': dict(learn_sigma=True, rescale_learned_sigmas=True),
    'kl': dict(learn_sigma=True, use_kl=True),
}


def _pair(variant, respacing='50', steps=1000):
    kw = dict(VARIANTS[variant], timestep_respacing=respacing,
              diffusion_steps=steps)
    return jgd.create_diffusion(**kw), tgd.create_diffusion(**kw)


@pytest.mark.parametrize('clip', [False, True], ids=['noclip', 'clip'])
@pytest.mark.parametrize('variant', ['learned_range', 'fixed_large',
                                     'fixed_small', 'start_x'])
def test_p_mean_variance_matches_jax(variant, clip):
    jd, td = _pair(variant)
    two_c = VARIANTS[variant]['learn_sigma']
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 8, 4)).astype(np.float32)
    t = np.array([0, 17, 49], np.int32)
    want = jd.p_mean_variance(_jmodel(1000, two_c), jnp.asarray(x),
                              jnp.asarray(t), clip_denoised=clip)
    got = td.p_mean_variance(_tmodel(1000, two_c), _t(x), _t(t).long(),
                             clip_denoised=clip)
    for k in ('mean', 'variance', 'log_variance', 'pred_xstart'):
        _close(torch.broadcast_to(got[k], got['mean'].shape),
               np.broadcast_to(np.asarray(want[k]), x.shape))


@pytest.mark.parametrize('masked', [True, False], ids=['mask', 'nomask'])
@pytest.mark.parametrize('variant', ['learned_range', 'fixed_large',
                                     'rescaled_mse', 'kl'])
def test_training_losses_match_jax(variant, masked):
    """MSE + vb (frozen mean), with the padded-token reweighting; t = 0
    takes the decoder NLL branch of the bound."""
    jd, td = _pair(variant, respacing='', steps=1000)
    two_c = VARIANTS[variant]['learn_sigma']
    rng = np.random.default_rng(2)
    x = np.clip(rng.standard_normal((3, 8, 4)), -1, 1).astype(np.float32)
    noise = rng.standard_normal(x.shape).astype(np.float32)
    t = np.array([0, 500, 999], np.int32)
    mask = np.ones((3, 8), np.float32)
    mask[1, 5:] = 0.0
    mask[2, 3:] = 0.0
    m = mask if masked else None
    want = jd.training_losses(
        jax.random.PRNGKey(0), _jmodel(1000, two_c), jnp.asarray(x),
        jnp.asarray(t), mask=None if m is None else jnp.asarray(m),
        noise=jnp.asarray(noise))
    got = td.training_losses(_tmodel(1000, two_c), _t(x), _t(t).long(),
                             mask=None if m is None else _t(m),
                             noise=_t(noise))
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k])


def _loop_noise(rng, shape, steps):
    """JAX's p_sample_loop / ddim_sample_loop per-step draws for ``rng``."""
    _, k_loop = jax.random.split(rng)
    keys = jax.random.split(k_loop, steps)
    return np.asarray(jax.vmap(
        lambda k: jax.random.normal(k, shape, jnp.float32))(keys))


@pytest.mark.parametrize('loop,eta', [('ddpm', 0.0), ('ddim', 0.0),
                                      ('ddim', 0.5)])
def test_respaced_loops_match_jax(loop, eta):
    """A 50-step respaced ladder of 1000, from the same initial noise, with
    JAX's per-step noise passed in."""
    jd, td = _pair('learned_range')
    rng = jax.random.PRNGKey(4)
    x0 = np.asarray(jax.random.normal(jax.random.PRNGKey(5), (2, 8, 4)))
    step_noise = _loop_noise(rng, x0.shape, 50)
    if loop == 'ddpm':
        want = jd.p_sample_loop(rng, _jmodel(1000), x0.shape,
                                noise=jnp.asarray(x0), clip_denoised=False)
        got = td.p_sample_loop(_tmodel(1000), x0.shape, noise=_t(x0),
                               clip_denoised=False,
                               step_noise=_t(step_noise))
    else:
        want = jd.ddim_sample_loop(rng, _jmodel(1000), x0.shape,
                                   noise=jnp.asarray(x0), clip_denoised=False,
                                   eta=eta)
        got = td.ddim_sample_loop(
            _tmodel(1000), x0.shape, noise=_t(x0), clip_denoised=False,
            eta=eta, step_noise=_t(step_noise) if eta else None)
    assert np.abs(np.asarray(want) - x0).max() > 0.1  # the loop moved x
    _close(got, want)


def test_loops_draw_from_the_generator():
    """Without step_noise the loop draws one (steps, *shape) block from the
    generator after the initial noise: the same seed, the same sample."""
    _, td = _pair('learned_range', respacing='10')
    runs = [td.p_sample_loop(_tmodel(1000), (2, 8, 4),
                             generator=torch.Generator().manual_seed(3))
            for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    gen = torch.Generator().manual_seed(3)
    x0 = torch.randn((2, 8, 4), generator=gen)
    noise = torch.randn((10, 2, 8, 4), generator=gen)
    again = td.p_sample_loop(_tmodel(1000), (2, 8, 4), noise=x0,
                             step_noise=noise)
    assert torch.equal(runs[0], again)
    with pytest.raises(ValueError, match='step_noise'):
        td.p_sample_loop(_tmodel(1000), (2, 8, 4), noise=x0,
                         step_noise=noise[:9])


def test_golden_anchor():
    """tests/goldens/ddpm.npz: a float64 numpy implementation sharing no
    code with either package; the respacing map, the eta-0 DDIM rollout
    and p_mean_variance."""
    T = int(GOLD['T'])
    td = tgd.create_diffusion(timestep_respacing=str(int(GOLD['n_resp'])),
                              noise_schedule='linear', learn_sigma=True,
                              diffusion_steps=T)
    np.testing.assert_array_equal(td.timestep_map, GOLD['tmap'])
    x = _t(GOLD['x_init'].astype(np.float32))
    out = td.ddim_sample_loop(_tmodel(T), x.shape, noise=x,
                              clip_denoised=False)
    np.testing.assert_allclose(out.numpy(), GOLD['x_final'], rtol=2e-4,
                               atol=2e-5)
    t = torch.full((x.shape[0],), int(GOLD['pmv_t']))
    pmv = td.p_mean_variance(_tmodel(T), x, t, clip_denoised=False)
    for key, gold in (('mean', 'pmv_mean'), ('log_variance', 'pmv_logvar'),
                      ('pred_xstart', 'pmv_pred_xstart')):
        np.testing.assert_allclose(pmv[key].numpy(), GOLD[gold], rtol=2e-4,
                                   atol=2e-5)


# -- timestep samplers and flow-match ladders -----------------------------------

def test_timestep_samplers_match_jax():
    """The same numpy Generator draws the same t and weights, before and
    after the second-moment resampler warms up."""
    for name in ('uniform', 'loss-second-moment'):
        js = jtsamp.create_named_schedule_sampler(name, 20)
        ts = ttsamp.create_named_schedule_sampler(name, 20)
        ga, gb = np.random.default_rng(0), np.random.default_rng(0)
        loss_rng = np.random.default_rng(1)
        for _ in range(80):
            (jt, jw), (tt, tw) = js.sample(8, ga), ts.sample(8, gb)
            np.testing.assert_array_equal(tt, jt)
            np.testing.assert_array_equal(tw, jw)
            losses = loss_rng.uniform(0, 1 + tt / 10.0)
            js.update_with_all_losses(jt, losses)
            ts.update_with_all_losses(tt, losses)
        np.testing.assert_array_equal(ts.weights(), js.weights())
    assert ts._warmed_up() and np.ptp(ts.weights()) > 0  # not flat
    with pytest.raises(NotImplementedError):
        ttsamp.create_named_schedule_sampler('bogus', 10)


FM_CONFIGS = {
    'default': dict(),
    'shift': dict(shift=3.0),
    'dynamic': dict(use_dynamic_shifting=True),
    'terminal': dict(shift_terminal=0.1),
    'karras': dict(use_karras_sigmas=True),
    'exponential': dict(use_exponential_sigmas=True),
    'beta': dict(use_beta_sigmas=True),
    'inverted': dict(invert_sigmas=True, shift=2.0),
}


@pytest.mark.parametrize('name', list(FM_CONFIGS))
def test_flow_match_ladders_are_bit_equal(name):
    kw = FM_CONFIGS[name]
    mu = jfm.calculate_shift(1024) if kw.get('use_dynamic_shifting') else None
    assert tfm.calculate_shift(1024) == jfm.calculate_shift(1024)
    want = jfm.set_timesteps(jfm.FlowMatchEulerConfig(**kw), 30, mu=mu)
    got = tfm.set_timesteps(tfm.FlowMatchEulerConfig(**kw), 30, mu=mu)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(tfm.linear_sigmas(7), jfm.linear_sigmas(7))
    grid = np.linspace(0.05, 0.95, 5)
    np.testing.assert_array_equal(tfm.time_shift(0.7, 1.0, grid),
                                  jfm.time_shift(0.7, 1.0, grid))


@pytest.mark.parametrize('stochastic', [False, True])
def test_flow_match_euler_step_matches_jax(stochastic):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 8, 4)).astype(np.float32)
    v = rng.standard_normal((2, 8, 4)).astype(np.float32)
    key = jax.random.PRNGKey(6)
    want = jfm.euler_step(jnp.asarray(x), jnp.asarray(v), jnp.float32(0.3),
                          jnp.float32(0.45), stochastic=stochastic,
                          rng=key if stochastic else None)
    noise = np.asarray(jax.random.normal(key, x.shape, jnp.float32))
    got = tfm.euler_step(_t(x), _t(v), 0.3, 0.45, stochastic=stochastic,
                         noise=_t(noise) if stochastic else None)
    _close(got, want, 1e-6)


# -- FiTv1 through build_sampler --------------------------------------------------

@pytest.fixture(scope='module')
def fitv1():
    """JAX FiTv1 + params (zero-init leaves perturbed) and the port FiT with
    the same weights."""
    jm = JFiT(**V1)
    g, _, s = j_grid(1, 4, 4, 16)
    params = jax.jit(lambda *a: jm.init(jax.random.PRNGKey(0), *a))(
        jnp.zeros((1, 16, 16)), jnp.zeros((1,)), jnp.zeros((1,), jnp.int32),
        g, None, s)['params']
    rng = np.random.default_rng(0)

    def perturb(path, v):
        p = jax.tree_util.keystr(path)
        if 'fc_out' in p or 'final_layer' in p:
            return v + 0.05 * rng.standard_normal(v.shape).astype(v.dtype)
        return v
    params = jax.tree_util.tree_map_with_path(perturb, params)
    pnp = jax.tree_util.tree_map(np.asarray, params)
    pm = FiT(**V1)
    pm.load_state_dict(state_dict_from_jax(pnp, **KW))
    return jm, params, pm.eval(), pnp


def _pipeline_noise(key, b_loop, steps):
    """JAX build_sampler's ddpm draws: z from the key, the loop's per-step
    noise from fold_in(key, 1)."""
    z = np.asarray(jax.random.normal(key, (B, 16, 16), jnp.float32))
    return z, _loop_noise(jax.random.fold_in(key, 1), (b_loop, 16, 16),
                          steps)


@pytest.mark.parametrize('mode,cfg_scale', [('ddpm', 1.5), ('ddim', 1.5),
                                            ('ddpm', 1.0)])
def test_fitv1_sampler_matches_jax(fitv1, mode, cfg_scale):
    jm, params, pm, _ = fitv1
    steps = 10
    kw = dict(image_height=64, image_width=64, num_sampling_steps=steps,
              cfg_scale=cfg_scale, num_classes=10, per_device_batch=B,
              sampler_mode=mode, diffusion_config=dict(learn_sigma=True))
    jfn = j_build_sampler(jm, params, JSamplingConfig(**kw,
                                                      dtype=jnp.float32))
    key = jax.random.PRNGKey(3)
    labels = np.array([1, 7])
    want = np.asarray(jfn(key, jnp.asarray(labels)))
    z, step_noise = _pipeline_noise(key, 2 * B if cfg_scale > 1 else B,
                                    steps)
    pfn = build_sampler(pm, SamplingConfig(**kw, dtype=torch.float32))
    got = pfn(_t(labels), z=_t(z),
              step_noise=_t(step_noise) if mode == 'ddpm' else None).numpy()
    assert got.shape == want.shape == (B, 4, 8, 8)
    z_img = pm.unpatchify(_t(z), (8, 8)).numpy()
    assert np.abs(want - z_img).max() > 0.1  # the sampler moved the latents
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= TOL_SAMPLER_REL_L2, rel


def test_fitv1_sampler_refusals(fitv1):
    _, _, pm, _ = fitv1
    base = dict(image_height=64, image_width=64, num_sampling_steps=4,
                num_classes=10, per_device_batch=B,
                diffusion_config=dict(learn_sigma=True))
    with pytest.raises(ValueError, match='velocity model'):
        build_sampler(pm, SamplingConfig(**base))  # 'ode' on learn_sigma
    for extra in (dict(velocity_eval_every=2), dict(guidance_low=0.3)):
        with pytest.raises(ValueError, match='composes with neither'):
            build_sampler(pm, SamplingConfig(**base, sampler_mode='ddim',
                                             **extra))
    with pytest.raises(ValueError, match='sampler_mode'):
        build_sampler(pm, SamplingConfig(**base, sampler_mode='euler'))
    fn = build_sampler(pm, SamplingConfig(**base, sampler_mode='ddpm',
                                          dtype=torch.float32))
    a = fn(torch.tensor([1, 2]), generator=torch.Generator().manual_seed(0))
    b = fn(torch.tensor([1, 2]), generator=torch.Generator().manual_seed(0))
    assert torch.equal(a, b) and torch.isfinite(a).all()


# -- the ddpm train step ------------------------------------------------------------

@pytest.fixture(scope='module')
def v1_batch(tmp_path_factory):
    """A batch of 4 from the JAX loader on synthetic non-square shards padded
    to 16 tokens, JAX init params, and the draws both packages take."""
    root = str(tmp_path_factory.mktemp('v1'))
    jld.make_synthetic_latent_shards(root, n=8, target_len=16, n_classes=10,
                                     seed=1)
    loader = jld.INLatentLoader(root, target_len=16, batch_size=4,
                                num_workers=1)
    it = loader.train_dataloader(4, 1, 0, seed=0, process_index=0,
                                 process_count=1)
    it.use_native = False
    batch = next(iter(it))
    assert (batch['mask'].sum(1) < 16).any()
    rng = np.random.default_rng(10)
    batch['t'] = np.array([0, 3, 500, 999], np.int32)
    draws = dict(noise=rng.standard_normal((4, 16, 16)).astype(np.float32),
                 drop_ids=np.array([0, 1, 0, 0], np.int32))
    jm = JFiT(**V1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jax.jit(lambda *a: jm.init(jax.random.PRNGKey(0), *a,
                                        train=True))(
        jb['feature'][:1], jnp.zeros((1,)), jb['label'][:1], jb['grid'][:1],
        jb['mask'][:1], jb['size'][:1])['params']
    prng = np.random.default_rng(0)

    def perturb(path, v):
        p = jax.tree_util.keystr(path)
        if 'fc_out' in p or 'final_layer' in p:
            return v + 0.05 * prng.standard_normal(v.shape).astype(v.dtype)
        return v
    return jax.tree_util.tree_map_with_path(perturb, params), batch, draws


def test_two_ddpm_train_steps_match_jax(v1_batch):
    params, batch, draws = v1_batch
    lr = 1e-4
    jm = JFiT(**V1)
    drop = jnp.asarray(draws['drop_ids'])

    class Shim:  # JAX's step draws the label drops itself: force them
        def apply(self, variables, *args, train, rngs):
            return jm.apply(variables, *args, train=True,
                            force_drop_ids=drop)

    jdiff = jgd.create_diffusion(timestep_respacing='', learn_sigma=True)
    noise = jnp.asarray(draws['noise'])
    given = types.SimpleNamespace(
        num_timesteps=jdiff.num_timesteps,
        training_losses=lambda rng, fn, x, t, mask=None:
            jdiff.training_losses(rng, fn, x, t, mask=mask, noise=noise))
    tx = jts.make_optimizer(jts.OptimizerConfig(learning_rate=lr))
    jstate = jts.create_train_state(params, tx)
    init = jax.device_get(jstate)
    jstep = jax.jit(j_make(Shim(), given, tx, ema_decay=0.9))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jmetrics = []
    for _ in range(2):
        jstate, m = jstep(jstate, jb, jax.random.PRNGKey(0))
        jmetrics.append(jax.device_get(m))
    jstate = jax.device_get(jstate)

    master = FiT(**V1)
    cfg = tts.OptimizerConfig(learning_rate=lr)
    state = train_state_from_jax(init, master, cfg)
    step = make_ddpm_train_step(master, tgd.create_diffusion(
        timestep_respacing='', learn_sigma=True), cfg.max_grad_norm,
        ema_decay=0.9)
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    td = {k: torch.from_numpy(v) for k, v in draws.items()}
    for jm_ in jmetrics:
        _, m = step(state, tb, draws=td)
        for k in ('loss', 'mse', 'grad_norm'):
            np.testing.assert_allclose(float(m[k]), float(jm_[k]), rtol=1e-5,
                                       err_msg=k)
        np.testing.assert_allclose(m['per_t_loss'].numpy(),
                                   jm_['per_t_loss'], rtol=1e-5)
        np.testing.assert_array_equal(m['t'].numpy(), jm_['t'])
    jp = state_dict_from_jax(jstate.params, **KW)
    je = state_dict_from_jax(jstate.ema_params, **KW)
    flips = total = 0
    for n, p in state.params.items():
        diff = (p.detach() - jp[n]).abs()
        assert diff.max() <= 2 * 2 * lr, n
        flips += int((diff > 2e-6).sum())
        total += diff.numel()
        assert (state.ema_params[n] - je[n]).abs().max() <= 2 * 2 * lr, n
    assert flips <= 0.01 * total, (flips, total)
    assert state.step == int(jstate.step) == 2


def test_ddpm_step_importance_weights_and_draws(v1_batch):
    """t_weight weighs each sample's loss (per_t_loss stays unweighted);
    without t in the batch, t is drawn from the generator."""
    params, batch, draws = v1_batch
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    td = {k: torch.from_numpy(v) for k, v in draws.items()}
    model = FiT(**V1)
    model.load_state_dict(state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params), **KW))
    diff = tgd.create_diffusion(timestep_respacing='', learn_sigma=True)
    from fitv2_tpu_torch.train.ddpm_train_step import ddpm_loss
    loss, m = ddpm_loss(model, diff, tb, draws=td)
    w = torch.tensor([0.5, 1.0, 2.0, 4.0])
    wloss, wm = ddpm_loss(model, diff, dict(tb, t_weight=w), draws=td)
    torch.testing.assert_close(wm['per_t_loss'], m['per_t_loss'])
    torch.testing.assert_close(wloss, (m['per_t_loss'] * w).mean())
    del tb['t']
    runs = [ddpm_loss(model, diff, tb,
                      generator=torch.Generator().manual_seed(5))[1]['t']
            for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    assert ((runs[0] >= 0) & (runs[0] < 1000)).all()


# -- the trainer and the CLIs ---------------------------------------------------------

@pytest.fixture(scope='module')
def shard_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('shards'))
    make_synthetic_latent_shards(root, n=32, target_len=16, n_classes=10)
    return root


def _trainer(shard_dir, out, **kw):
    torch.manual_seed(0)
    cfg = dict(data_path=shard_dir, target_len=16, global_batch_size=8,
               num_workers=2, max_steps=6, learning_rate=1e-3,
               lr_schedule='constant', output_dir=out, checkpointing_steps=4,
               log_every=1, seed=0, device='cpu', loader_backend='python',
               objective='ddpm', diffusion_steps=100)
    cfg.update(kw)
    return Trainer(FiT(**V1), TrainerConfig(**cfg))


def test_ddpm_trainer_resume_is_bit_identical(shard_dir, tmp_path):
    """6 ddpm steps against 4, a checkpoint and a resumed run to 6; the
    logged metrics are the scalars (per_t_loss and t stay out)."""
    logged = []
    full = _trainer(shard_dir, str(tmp_path / 'a')).train(
        resume=False, metric_hook=lambda s, m: logged.append(m))
    _trainer(shard_dir, str(tmp_path / 'b')).train(max_steps=4, resume=False)
    tr = _trainer(shard_dir, str(tmp_path / 'b'))
    resumed = tr.train(max_steps=6)
    assert tr.diffusion.num_timesteps == 100
    assert full.step == resumed.step == 6
    for n in full.params:
        assert torch.equal(full.params[n], resumed.params[n]), n
        assert torch.equal(full.ema_params[n], resumed.ema_params[n]), n
    assert logged and set(logged[0]) == {'loss', 'grad_norm', 'mse',
                                         'steps_per_sec'}
    assert all(np.isfinite(m['loss']) for m in logged)
    with pytest.raises(ValueError, match='objective'):
        _trainer(shard_dir, str(tmp_path / 'c'), objective='vae')


def _small_fit_xl_override(tmp_path, data_path):
    """A YAML merged after configs/fit_xl.yaml: FiTv1-XL's structure at
    V1's width and depth, batch 4 of 16-token shards."""
    params = {k: V1[k] for k in ('context_size', 'hidden_size', 'depth',
                                 'num_heads', 'num_classes',
                                 'max_cached_len')}
    cfg = {'diffusion': {'network_config': {'params': params},
                         'diffusion_steps': 100},
           'data': {'params': {'train': {
               'data_path': data_path, 'target_len': 16,
               'loader': {'batch_size': 4, 'num_workers': 1}}}},
           'accelerate': {'lr_warmup_steps': 10, 'checkpointing_steps': 100}}
    path = str(tmp_path / 'small.yaml')
    with open(path, 'w') as f:
        yaml.safe_dump(cfg, f)
    return path


def test_cli_train_fit_xl_selects_ddpm_on_the_cpu(shard_dir, tmp_path):
    """configs/fit_xl.yaml (learn_sigma) with a small-size override: the
    CLI trains the ddpm objective with the config's diffusion_steps."""
    from fitv2_tpu_torch.utils.config import load_config
    cfgs = [os.path.join(REPO, 'configs', 'fit_xl.yaml'),
            _small_fit_xl_override(tmp_path, shard_dir)]
    out = str(tmp_path / 'run')
    cli_train.main(['--cfgdir', *cfgs, '--device', 'cpu', '--max-steps', '2',
                    '--output-dir', out, '--no-resume'])
    assert os.listdir(os.path.join(out, 'checkpoints')) == ['checkpoint-2']
    assert cli_train.parse_args(['--cfgdir', *cfgs]).device == 'cuda'
    args = cli_train.parse_args(['--cfgdir', *cfgs, '--device', 'cpu'])
    tr = cli_train.build_trainer(load_config(cfgs), args)
    assert tr.cfg.objective == 'ddpm' and tr.cfg.diffusion_steps == 100
    assert tr.model.learn_sigma and tr.diffusion.num_timesteps == 100


def test_cli_diffusion_config_matches_jax():
    for section in ({'diffusion_steps': 1000, 'noise_schedule': 'linear',
                     'network_config': {}},
                    {'improved_diffusion': {'timestep_respacing': '250',
                                            'learn_sigma': True,
                                            'noise_schedule': 'cosine'},
                     'noise_schedule': 'linear', 'sigma_small': True}):
        assert cli_sample._diffusion_config(section) == \
            jcli_sample._diffusion_config(section)


@pytest.mark.parametrize('mode', ['ddpm', 'ddim'])
def test_cli_samples_fit_xl_on_the_cpu(fitv1, tmp_path, mode):
    """configs/fit_xl.yaml with a small-size override through main() with
    --sampler-mode: the npz equals the same run through the library."""
    _, _, pm, pnp = fitv1
    cfgs = [os.path.join(REPO, 'configs', 'fit_xl.yaml'),
            _small_fit_xl_override(tmp_path, 'unused')]
    ckpt = str(tmp_path / 'v1.safetensors')
    save_safetensors(export_fit_state_dict(pnp, **KW, rope_layout='split'),
                     ckpt)
    out = str(tmp_path / f'{mode}.npz')
    cli_sample.main(['--cfgdir', *cfgs, '--ckpt', ckpt, '--image-height',
                     '64', '--image-width', '64', '--num-sampling-steps', '3',
                     '--num-fid-samples', '3', '--per-device-batch', '2',
                     '--num-classes', '10', '--global-seed', '5',
                     '--sampler-mode', mode, '--device', 'cpu', '--out', out])
    arr = np.load(out)['arr_0']
    assert arr.shape == (3, 4, 8, 8) and np.isfinite(arr).all()
    fn = build_sampler(pm, SamplingConfig(
        image_height=64, image_width=64, num_sampling_steps=3,
        num_classes=10, per_device_batch=2, sampler_mode=mode,
        diffusion_config=dict(diffusion_steps=100, noise_schedule='linear')))
    np.testing.assert_allclose(
        arr, generate_fid_samples(fn, 3, 2, num_classes=10, seed=5),
        rtol=1e-6, atol=1e-6)
